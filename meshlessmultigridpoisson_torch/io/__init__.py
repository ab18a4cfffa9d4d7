"""Setup bundles, the setup cache, solver checkpoints and txt vectors."""

from meshlessmultigridpoisson_torch.io.bundle import (
    StampError,
    load_bundle,
    load_problem,
    load_state,
    read_vector_txt,
    save_bundle,
    save_problem,
    save_state,
    write_vector_txt,
)

__all__ = ["StampError", "load_bundle", "load_problem", "load_state", "read_vector_txt",
           "save_bundle", "save_problem", "save_state", "write_vector_txt"]
