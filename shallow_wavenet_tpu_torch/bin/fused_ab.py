"""Trained-model decode A/B, the fused window against the default (unfused)
kernel — the torch twin of `tools/fused_ab.py`.

Replays recipe stages 5-6 twice on an existing `bin.run` workdir, with the
same checkpoint and seed (the same uniforms), once unfused and once with
`--fused W`, and prints the copy-synthesis MCD of each and the difference:
the quality gate of the fused window, which is not bit-exact against the
unfused kernel. Writes `<workdir>/gen_<tag>/`, `restored_<tag>/` (where the
config shapes noise) and `mcd_<tag>.json` for tag `unfused` and `fused<W>`.

    python -m shallow_wavenet_tpu_torch.bin.fused_ab exp [--fused 4] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from shallow_wavenet_tpu_torch.bin import decode, mcd_eval, noise_shaping
from shallow_wavenet_tpu_torch.config import Config


def run(workdir, fused: int = 4, device=None, log=print) -> dict:
    """{tag: mean MCD} of the unfused and the fused-W decode of `workdir`'s
    eval set, through the decode, noise_shaping and mcd_eval CLIs."""
    wd = Path(workdir)
    cfg_path = wd / "model" / "config.json"
    cfg = Config.from_json(cfg_path.read_text())
    cfg_args = ["--config", str(cfg_path)]
    dev = [] if device is None else ["--device", str(device)]
    eval_scp = str(wd / "corpus" / "eval.scp")
    stats = str(wd / "stats.h5")
    results = {}
    for tag, extra in (("unfused", []), (f"fused{fused}",
                                         ["--fused", str(fused)])):
        gen = wd / f"gen_{tag}"
        decode.main(["--eval-scp", eval_scp, "--feats-dir", str(wd / "feats"),
                     "--stats", stats, "--workdir", str(wd / "model"),
                     "--outdir", str(gen), "--seed", "0", *extra, *dev,
                     *cfg_args])
        final = gen
        if cfg.noise_shaping.enabled:
            final = wd / f"restored_{tag}"
            noise_shaping.main(["--wav-scp", eval_scp, "--stats", stats,
                                "--outdir", str(final), "--inv", "--indir",
                                str(gen), *dev, *cfg_args])
        out = wd / f"mcd_{tag}.json"
        mcd_eval.main(["--ref-scp", eval_scp, "--gen-dir", str(final),
                       "--out", str(out), *dev, *cfg_args])
        results[tag] = json.loads(out.read_text())["mcd_db_mean"]
    a, b = results
    log(f"A/B: {a} {results[a]:.3f} dB, {b} {results[b]:.3f} dB, "
        f"|delta| {abs(results[a] - results[b]):.3f} dB")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir", help="a bin.run workdir (stages 0-4 done)")
    ap.add_argument("--fused", type=int, default=4,
                    help="fused window W of the B side")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on the host)")
    args = ap.parse_args(argv)
    return run(args.workdir, args.fused, args.device)


if __name__ == "__main__":
    main()
