"""Compare the SASS of `csrc/ar_cluster.cu`'s production instances with those
of another version of the source (e.g. a parent commit's), instruction for
instruction, mangled names aside.

    git show <commit>:shallow_wavenet_tpu_torch/csrc/ar_cluster.cu > old.cu
    python3 -m shallow_wavenet_tpu_torch.bin.sass_diff old.cu \
        [--out DIR] [--probe]

Builds both with the production flags (`ops._build.NVCC_FLAGS`, ptxas's
register report on), disassembles them with `cuobjdump -sass` and prints,
for each kernel of the old source, its instruction count on both sides
and whether they are identical (the first differing positions if not),
then both sides' registers per kernel. A kernel is matched by its name
from `ar_cluster_kernel` on, with the probe's production template
arguments (`Li0ELb0E`, kAblFull and untimed) and the wide form's (`Lb0E`,
off) removed. With `--probe`, the probe library's instances instead (both
sources built with its flags, `-DAR_CLUSTER_PROBE`; a few minutes). Exits
1 unless every kernel is identical. Needs nvcc and cuobjdump (the CUDA
toolkit), no card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from shallow_wavenet_tpu_torch.ops import _build


def _key(name: str) -> str:
    return re.sub(r"Li0ELb0E(Lb0E)?", "",
                  name[name.index("ar_cluster_kernel"):])


def sass(lib: Path) -> dict:
    """{kernel name: [instructions]} of a library, `cuobjdump -sass`."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    txt = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append(re.sub(r"\s+", " ", m.group(1)))
    return funcs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old", type=Path, help="the other ar_cluster.cu")
    p.add_argument("--out", type=Path, default=None,
                   help="directory for the builds and logs (default: a "
                        "temporary one)")
    p.add_argument("--probe", action="store_true",
                   help="compare the probe library's instances")
    args = p.parse_args(argv)
    flags = _build.LIBRARIES["ar_cluster_probe" if args.probe
                             else "ar_cluster"][1]
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or Path(tmp)
        out.mkdir(parents=True, exist_ok=True)
        srcs = {"old": args.old, "new": _build.CSRC / "ar_cluster.cu"}
        procs = {k: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, *_build.LOG_FLAGS,
             "-o", str(out / f"{k}.so"), str(src)],
            stdout=open(out / f"{k}.log", "w"), stderr=subprocess.STDOUT)
            for k, src in srcs.items()}
        if any(proc.wait() for proc in procs.values()):
            for k in procs:
                sys.stderr.write((out / f"{k}.log").read_text()[-4000:])
            return 1
        old, new = ({_key(k): v for k, v in sass(out / f"{s}.so").items()}
                    for s in ("old", "new"))
        same = 0
        for k, v in old.items():
            w = new.get(k)
            if w is None:
                print(f"{k}: missing from the new source")
                continue
            diff = [i for i, (a, b) in enumerate(zip(v, w)) if a != b]
            ok = v == w
            same += ok
            print(f"{k}: {len(v)} / {len(w)} instructions, "
                  + ("identical" if ok else f"differ at {diff[:5]}"))
        print(f"identical: {same} of {len(old)}")
        for k in srcs:
            print(k, [int(r) for r in re.findall(
                r"Used (\d+) registers", (out / f"{k}.log").read_text())])
    return 0 if same == len(old) and old else 1


if __name__ == "__main__":
    sys.exit(main())
