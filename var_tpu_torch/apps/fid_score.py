"""FID scoring CLI (counterpart of ``var_tpu/apps/fid_score.py``), the
in-repo replacement for the OpenAI evaluator step (reference
``README.md:153-156``)::

    python -m var_tpu_torch.apps.fid_score REF SAMPLES [--extractor vae] [--device cpu]

REF / SAMPLES each accept a folder of PNGs (read with Pillow), a packed
images npz (``arr_0``) or a precomputed-stats npz (``mu`` + ``sigma``, the
format the OpenAI reference batches ship in, usable directly with
``--extractor inception``). The extractor runs on ``--device`` (``cuda``
by default; ``cpu`` runs the plain PyTorch path). Prints one JSON line with
the score.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ref", help="reference: PNG folder / images npz / stats npz")
    p.add_argument("samples", help="samples: PNG folder / images npz / stats npz")
    p.add_argument("--extractor", default="vae", choices=("vae", "pixel", "inception"))
    p.add_argument("--vae_ckpt", default="vae_ch160v4096z32.pth",
                   help="VAE weights for --extractor vae (random init if absent)")
    p.add_argument("--inception_pt", default="pt_inception-2015-12-05-6726825d.pt",
                   help="TorchScript InceptionV3 for --extractor inception")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--limit", type=int, default=None,
                   help="score only the first N images of each side")
    p.add_argument("--save_stats", default="",
                   help="also write the SAMPLES side's (mu, sigma) npz here")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from var_tpu_torch.metrics import fid as F

    extractor = F.get_extractor(args.extractor, device=args.device, vae_ckpt=args.vae_ckpt,
                                inception_pt=args.inception_pt)
    # a vae extractor without the checkpoint runs random-projection features
    # in a different space: the metric's name says so, and so does stderr,
    # so trend numbers from different machines are never silently compared
    space = getattr(extractor, "feature_space", args.extractor)
    if space == "vae_randproj":
        sys.stderr.write(f"[fid_score] WARNING: {args.vae_ckpt!r} not found — "
                         "scoring with seeded RANDOM-PROJECTION VAE features "
                         "(metric fid_vae_randproj). Comparable only with "
                         "other randproj scores from the same seed.\n")
    mu_r, s_r = F.path_stats(args.ref, extractor, batch=args.batch, limit=args.limit)
    mu_s, s_s = F.path_stats(args.samples, extractor, batch=args.batch, limit=args.limit)
    score = F.frechet_distance(mu_r, s_r, mu_s, s_s)
    if args.save_stats:
        import numpy as np

        np.savez(args.save_stats, mu=mu_s, sigma=s_s)
    print(json.dumps({"metric": f"fid_{space}", "value": round(score, 6),
                      "ref": args.ref, "samples": args.samples}))
    return score


if __name__ == "__main__":
    main()
