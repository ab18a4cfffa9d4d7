"""Global loads of the built kernel library, per kernel instance (CUDA toolkit).

``library_loads`` disassembles the kernel library
(``gpu_kernels.LIB_PATH``) with ``cuobjdump -sass`` and counts, for each
kernel instance (its mangled name), each global-load opcode (``LDG...``)
in its code.  It needs ``cuobjdump``, not a card.  The registers of each
instance are in the library build's own ``-Xptxas -v`` output.

What it shows: the stream kernel's ``f32i16`` instance (template argument
3, ``stream_kernelILi3E``) reads its whole i16 table only while every i16
load stays live, i.e. while its code holds as many 64-bit loads (a short4
of the i16 table) as 128-bit ones (a float4 of the f32 table)
(``i16_loads_live``).  ``chip_smoke.py`` checks that on the built library.
"""

from __future__ import annotations

import os
import re
import subprocess

I16_INSTANCE = "stream_kernelILi3E"  # StreamMix kF32I16 = 3


def _tool(name: str) -> str:
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    return os.path.join(os.path.dirname(gk._nvcc()), name)


def sass_loads(path: str) -> dict[str, dict[str, int]]:
    """Per kernel of the object or library at ``path``: global-load opcode
    -> count, from ``cuobjdump -sass``."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, dict[str, int]] = {}
    loads = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            loads = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"\b(LDG\S*)", line)
        if m and loads is not None:
            loads[m.group(1)] = loads.get(m.group(1), 0) + 1
    return out


def library_loads(lib_path: str | None = None) -> dict[str, dict[str, int]]:
    """``sass_loads`` of the built kernel library."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    return sass_loads(lib_path or gk.LIB_PATH)


def i16_loads_live(loads: dict[str, dict[str, int]]) -> bool:
    """Whether the f32i16 stream instance loads a short4 of the i16 table
    for every float4 of the f32 table."""
    inst = [v for k, v in loads.items() if I16_INSTANCE in k]
    return (len(inst) == 1 and inst[0].get("LDG.E.64", 0) > 0
            and inst[0].get("LDG.E.64") == inst[0].get("LDG.E.128"))
