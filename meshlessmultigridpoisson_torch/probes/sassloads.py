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

``compare`` tells whether two sources compile a kernel's instances to the
same SASS:

    python -m meshlessmultigridpoisson_torch.probes.sassloads OLD.cu NEW.cu KERNEL

compiles each source on its own (``nvcc -cubin`` with the kernel library's
flags, the source's directory on the include path), disassembles it and,
for every instance of ``KERNEL`` in OLD, takes the instance of NEW with the
same template arguments, where NEW may add trailing template arguments at
the value 0 (a compile-time mode whose 0 is the production code: ``<float,
float>`` in OLD is ``<float, float, 0>`` in NEW).  It compares their
instructions, opcodes and operands, in order (addresses and encodings
dropped), prints a line per instance and, last, a JSON line, and exits
non-zero if an instance differs or has no counterpart.  Needs ``nvcc``,
``cuobjdump`` and ``cu++filt``, not a card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

I16_INSTANCE = "stream_kernelILi3E"  # StreamMix kF32I16 = 3
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _tool(name: str) -> str:
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    return os.path.join(os.path.dirname(gk._nvcc()), name)


def sass_functions(path: str) -> dict[str, list[str]]:
    """Per kernel (mangled name) of the object, cubin or library at
    ``path``: its instructions in order, opcode and operands
    (``cuobjdump -sass``; addresses and encodings dropped)."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append(" ".join(m.group(1).split()))
    return out


def sass_loads(path: str) -> dict[str, dict[str, int]]:
    """Per kernel of the object or library at ``path``: global-load opcode
    -> count."""
    out: dict[str, dict[str, int]] = {}
    for name, insns in sass_functions(path).items():
        loads = out.setdefault(name, {})
        for insn in insns:
            m = re.search(r"\b(LDG\S*)", insn)
            if m:
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


def _args(sig: str, kernel: str) -> list[str] | None:
    """The template arguments of ``kernel`` in demangled signature ``sig``."""
    m = re.search(re.escape(kernel) + r"<", sig)
    if m is None:
        return None
    depth, start, out = 1, m.end(), []
    i = start
    while depth:
        c = sig[i]
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        if depth == 0 or (depth == 1 and c == ","):
            out.append(sig[start:i].strip())
            start = i + 1
        i += 1
    return out


def kernel_sass(src: str, kernel: str) -> dict[tuple, list[str]]:
    """Template arguments -> instructions of each instance of ``kernel``
    that ``src`` compiles."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    flags = [f for f in gk.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([gk._nvcc(), *flags, "-cubin", "-I", os.path.dirname(os.path.abspath(src)),
                        "-o", cubin, src], check=True, capture_output=True, text=True)
        funcs = sass_functions(cubin)
    names = list(funcs)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(names), check=True,
                               capture_output=True, text=True).stdout.splitlines()
    out = {}
    for name, sig in zip(names, demangled):
        args = _args(sig, kernel)
        if args is not None:
            out[tuple(args)] = funcs[name]
    return out


def compare(old: str, new: str, kernel: str) -> dict:
    """Per instance of ``kernel`` in ``old``: its instruction count, its
    counterpart's in ``new`` and the first instruction where they differ."""
    a, b = kernel_sass(old, kernel), kernel_sass(new, kernel)
    rows = {}
    for args, insns in a.items():
        match = [k for k in b if k[:len(args)] == args
                 and all(v in ("0", "(int)0") for v in k[len(args):])]
        if len(match) != 1:
            rows["<" + ", ".join(args) + ">"] = dict(old=len(insns), new=None, same=False,
                                                    first_diff=None)
            continue
        other = b[match[0]]
        diff = next((i for i, (p, q) in enumerate(zip(insns, other)) if p != q),
                    None if len(insns) == len(other) else min(len(insns), len(other)))
        rows["<" + ", ".join(args) + ">"] = dict(
            old=len(insns), new=len(other), same=diff is None, first_diff=diff,
            new_args="<" + ", ".join(match[0]) + ">",
            old_insn=None if diff is None or diff >= len(insns) else insns[diff],
            new_insn=None if diff is None or diff >= len(other) else other[diff])
    return dict(kernel=kernel, old=old, new=new, instances=rows,
                same=bool(rows) and all(r["same"] for r in rows.values()))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        raise SystemExit(__doc__)
    res = compare(*argv)
    for args, r in res["instances"].items():
        print(f"{res['kernel']}{args}: {r['old']} instructions, counterpart "
              f"{r.get('new_args')} {r['new']}: "
              + ("the same" if r["same"] else
                 f"differ at {r['first_diff']}: {r.get('old_insn')!r} / {r.get('new_insn')!r}"),
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0 if res["same"] else 1


if __name__ == "__main__":
    sys.exit(main())
