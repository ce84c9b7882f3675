"""What ptxas and the SASS say about every kernel in ``ops/csrc``.

    python -m horovod_tpu_torch.experiments.kernel_sass [--compare TREE]

Compiles each ``ops/csrc/*.cu`` with the build's own nvcc flags plus
``-Xptxas -v`` into a temporary directory, disassembles the object with
``cuobjdump -sass`` and prints one JSON line per kernel: registers,
spill stores and loads in bytes, stack frame, the count of ``HGMMA``
(wgmma) and ``HMMA`` (mma.sync) instructions and of wgmma waits
(``WARPGROUP.DEPBAR``; one per batch unless ptxas serialized the
pipeline), ptxas's notes on the kernel (``perf_notes``: its "Potential
Performance Loss" lines, such as a wgmma pipeline it serialized, with
the reason), and the warnings ptxas printed for the kernel's source
file. With
``--compare TREE`` (the root of another checkout) the same sources of
that tree are built too, and each kernel's line says whether its SASS is
identical there (instruction text and encoding, the function's own
name left out);
``--diff N`` then prints the first N lines of the unified diff of each
kernel whose SASS differs.
Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import subprocess
import tempfile
from pathlib import Path

from ..ops import _build

_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def _key(mangled: str) -> str:
    """A kernel's mangled name without its anonymous namespace, which is
    named after the file and differs between builds."""
    return _ANON.sub("", mangled)


def _tool(name: str) -> str:
    return str(Path(_build._nvcc()).with_name(name))


def ptxas_info(stderr: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack,
    perf_notes}} from the ``-Xptxas -v`` report; a "Potential
    Performance Loss" note belongs to the function it names."""
    out, fn = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Performance Loss: (.*) in the function '(\S+)'",
                      line)
        if m:
            notes = out.setdefault(_key(m.group(2)), {}).setdefault(
                "perf_notes", [])
            notes.append(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _key(m.group(1))
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_bodies(sass: str, names=None) -> dict:
    """{kernel: [instruction lines]} from ``cuobjdump -sass``, runs of
    blanks collapsed (cuobjdump pads its comment column to the widest
    instruction in the file); ``names`` collects {kernel: mangled
    name}."""
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _key(m.group(1))
            out[fn] = []
            if names is not None:
                names[fn] = m.group(1)
        elif fn is not None and "/*" in line:
            out[fn].append(" ".join(line.split()))
    return out


def inventory(csrc: Path) -> dict:
    """{kernel: {source, registers, ..., HGMMA, HMMA, sass}}."""
    kernels = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(csrc.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            built = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", str(obj), str(src)],
                capture_output=True, text=True, check=True)
            sass = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            info = ptxas_info(built.stderr)
            warnings = [line.strip() for line in built.stderr.splitlines()
                        if "warning" in line.lower()]
            names = {}
            for fn, body in sass_bodies(sass, names).items():
                kernels[fn] = {
                    "mangled": names[fn], "source": src.name,
                    **info.get(fn, {}),
                    "HGMMA": sum("HGMMA" in s for s in body),
                    "HMMA": sum("HMMA" in s and "HGMMA" not in s
                                for s in body),
                    "wgmma_waits": sum("WARPGROUP.DEPBAR" in s
                                       for s in body),
                    "ptxas_warnings": warnings,
                    "sass": body}
    return kernels


def _demangle(names):
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", metavar="TREE",
                    help="root of another checkout whose kernels' SASS to "
                         "compare with")
    ap.add_argument("--diff", type=int, default=0, metavar="N",
                    help="with --compare, print N lines of each differing "
                         "kernel's SASS diff")
    args = ap.parse_args(argv)
    mine = inventory(_build.CSRC)
    other = None
    if args.compare:
        other = inventory(Path(args.compare) / "horovod_tpu_torch" / "ops"
                          / "csrc")
    keys = sorted(mine)
    pretty = _demangle([mine[fn]["mangled"] for fn in keys])
    for fn, name in zip(keys, pretty):
        row = {k: v for k, v in mine[fn].items()
               if k not in ("sass", "mangled")}
        row = {"kernel": name, **row, "sass_lines": len(mine[fn]["sass"])}
        if other is not None:
            theirs = other.get(fn, {}).get("sass", [])
            row["sass_identical"] = theirs == mine[fn]["sass"]
            if args.diff and not row["sass_identical"]:
                diff = list(difflib.unified_diff(theirs, mine[fn]["sass"],
                                                 args.compare, "this tree",
                                                 lineterm="", n=1))
                row["diff"] = diff[:args.diff]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
