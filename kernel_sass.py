"""Compares the compiled code of two trees' kernels on the card's
toolchain: the SASS of every kernel instantiation and its registers.

    python3 kernel_sass.py --old _archive/old/bvh_tpu_torch

``--old`` (and ``--new``, default this checkout's ``bvh_tpu_torch``) name a
package directory whose ``csrc/`` holds ``wide_trace.cu``, ``tight_trace.cu``,
``sweep.cu``, ``cluster_trace.cu`` (the includers of ``trace_common.cuh``)
and ``nearest.cu``. Each source is compiled to a cubin with the flags
of ``ops/_build.py::NVCC_FLAGS`` (the library flags dropped), its SASS read
with ``cuobjdump -sass``, its resource use with ``cuobjdump -res-usage``
and its spills from the compiler's own report (``-Xptxas -v``). An old
instantiation is paired with the new one whose template arguments are the
old ones followed only by false (flags the new tree added, off); the two
must have the same instructions, line for line, and the same registers,
except a pair whose new instantiation matches a ``--may-differ`` pattern
(a regular expression; a build a change alters on purpose), which is
reported beside the others. The new tree's
other instantiations (a flag on) are listed with their registers. Every
instantiation's spill stores and loads (bytes) are reported. Prints one
JSON object and exits 1 when a pair differs.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from bvh_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

SOURCES = ("wide_trace.cu", "tight_trace.cu", "sweep.cu", "cluster_trace.cu",
           "nearest.cu")
OFF = ("false", "(bool)0")  # a template flag off, as cu++filt prints it


def _tool(name: str) -> str:
    """A CUDA toolkit binary beside ``nvcc``."""
    return str(Path(_nvcc()).parent / name)


def _cubin(src: Path, out: Path) -> dict[str, list[int]]:
    """Compiles ``src`` to the cubin ``out``; each kernel's (mangled name)
    spill stores and loads in bytes, from ptxas's report."""
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    log = subprocess.run([_nvcc(), *flags, "-Xptxas", "-v", "-cubin",
                          str(src), "-o", str(out)], check=True,
                         capture_output=True, text=True).stderr
    return {m.group(1): [int(m.group(2)), int(m.group(3))] for m in
            re.finditer(r"Function properties for (\S+)\s+\d+ bytes stack "
                        r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", log)}


def _demangle(names: list[str]) -> dict[str, str]:
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         check=True, capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out))


def _kernels(cubin: Path, spills: dict) -> dict[str, dict]:
    """Each kernel's (template name -> instructions, registers, spill
    stores and loads)."""
    dump = _tool("cuobjdump")
    sass = subprocess.run([dump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    res = subprocess.run([dump, "-res-usage", str(cubin)], check=True,
                         capture_output=True, text=True).stdout
    code: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
        elif name is not None:
            # an instruction without its address and encoding comments
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            ins = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ins).strip()
            if ins:
                code[name].append(ins)
    regs = {m.group(1): int(m.group(2)) for m in
            re.finditer(r"Function (\S+):\s*REG:(\d+)", res)}
    pretty = _demangle(list(code))
    out = {}
    for mangled, lines in code.items():
        m = re.search(r"(\w+_kernel)(?:<([^>]*)>)?", pretty[mangled])
        targs = m.group(2)
        key = (m.group(1), tuple(a.strip() for a in targs.split(","))
               if targs else ())
        out[key] = {"sass": lines, "regs": regs.get(mangled),
                    "spills": spills.get(mangled)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--new", type=Path,
                    default=Path(__file__).resolve().parent / "bvh_tpu_torch")
    ap.add_argument("--may-differ", action="append", default=[],
                    metavar="REGEX")
    args = ap.parse_args()
    report, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            built = {}
            for tree in ("old", "new"):
                out = Path(tmp) / f"{tree}_{src}.cubin"
                spills = _cubin(getattr(args, tree) / "csrc" / src, out)
                built[tree] = _kernels(out, spills)
            pairs, extra = [], []
            for (kname, targs), new in sorted(built["new"].items()):
                old_key = None
                for n in range(len(targs), -1, -1):
                    if all(a in OFF for a in targs[n:]) and \
                            (kname, targs[:n]) in built["old"]:
                        old_key = (kname, targs[:n])
                        break
                if old_key is None:
                    extra.append({"kernel": f"{kname}<{', '.join(targs)}>",
                                  "regs": new["regs"],
                                  "spills": new["spills"]})
                    continue
                old = built["old"][old_key]
                same = old["sass"] == new["sass"] and old["regs"] == new["regs"]
                name = f"{kname}<{', '.join(targs)}>"
                may = any(re.search(x, name) for x in args.may_differ)
                ok &= same or may
                pairs.append({"old": f"{kname}<{', '.join(old_key[1])}>",
                              "new": name, "may_differ": may,
                              "sass_equal": old["sass"] == new["sass"],
                              "instructions": len(new["sass"]),
                              "regs_old": old["regs"], "regs_new": new["regs"],
                              "spills_old": old["spills"],
                              "spills_new": new["spills"]})
            unpaired = [f"{k}<{', '.join(a)}>" for k, a in built["old"]
                        if not any(p["old"] == f"{k}<{', '.join(a)}>"
                                   for p in pairs)]
            ok &= not unpaired
            report[src] = {"pairs": pairs, "new_only": extra,
                           "old_unpaired": unpaired}
    print(json.dumps({"ok": ok, "sources": report}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
