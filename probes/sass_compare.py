#!/usr/bin/env python3
"""Did a change to a CUDA source leave its machine code as it was? Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no card.

    python3 probes/sass_compare.py OLD_CSRC NEW_CSRC NAME [NAME ...]

Builds ``NAME.cu`` of each ``csrc`` directory (with the headers beside
it) into a cubin with the library's own flags (``_build.NVCC_FLAGS``,
``sm_90a``), all builds at once, and compares per kernel: the ptxas
report (registers, spills, stack) and the SASS, with the instructions'
offsets and the hash that names a file's anonymous namespace taken out
(it follows the file's path). Prints one JSON line per source: the
kernels of each side, those whose report or SASS differ, and for the
first few of these the first differing lines.
"""
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import _build  # noqa: E402

CUBIN_FLAGS = [f for f in _build.NVCC_FLAGS
               if f not in ("-shared", "-Xcompiler", "-fPIC")] + ["-cubin"]
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def normal(text):
    return ANON.sub("_GLOBAL__N__", text)


def by_kernel(sass):
    """{kernel: [lines]} of ``cuobjdump -sass`` output, offsets removed."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = normal(m.group(1))
            out[name] = []
        elif name is not None:
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", normal(line)).strip()
            if line:
                out[name].append(line)
    return out


def reports(log):
    """{kernel: ptxas lines} from ``-Xptxas -v``'s report."""
    out, name = {}, None
    for line in normal(log).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None and re.search(
                r"registers|spill|stack frame", line):
            out[name].append(line.split(":", 1)[-1].strip())
    return out


def main(argv):
    if len(argv) < 3:
        sys.exit(__doc__)
    dirs = {"old": Path(argv[0]), "new": Path(argv[1])}
    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name in argv[2:]:
            for side, d in dirs.items():
                cubin = Path(tmp) / f"{name}_{side}.cubin"
                jobs[name, side] = (cubin, subprocess.Popen(
                    [nvcc, *CUBIN_FLAGS, "-o", str(cubin),
                     str(d / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        for name in argv[2:]:
            side_sass, side_rep = {}, {}
            for side in dirs:
                cubin, proc = jobs[name, side]
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    sys.exit(f"{name} ({side}) did not build:\n{log}")
                side_rep[side] = reports(log)
                side_sass[side] = by_kernel(subprocess.run(
                    [cuobjdump, "-sass", str(cubin)], check=True,
                    capture_output=True, text=True).stdout)
            old, new = side_sass["old"], side_sass["new"]
            differ = sorted(k for k in set(old) | set(new)
                            if old.get(k) != new.get(k))
            first = {}
            for k in differ[:4]:
                a, b = old.get(k, []), new.get(k, [])
                i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                first[k] = {"lines": [len(a), len(b)], "at": i,
                            "old": a[i:i + 2], "new": b[i:i + 2]}
            print(json.dumps({
                "source": f"{name}.cu",
                "kernels": [len(old), len(new)],
                "sass_differs": differ,
                "report_differs": sorted(
                    k for k in set(side_rep["old"]) | set(side_rep["new"])
                    if side_rep["old"].get(k) != side_rep["new"].get(k)),
                "first_differences": first,
            }))


if __name__ == "__main__":
    main(sys.argv[1:])
