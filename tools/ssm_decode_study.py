#!/usr/bin/env python3
"""Where the f32 prefill of the SSM archs parts from their decode, on one
card.

    python3 tools/ssm_decode_study.py [--tokens 600] [--out FILE]

For ``mamba2-780m`` (48 layers) and ``hymba-1.5b`` (32 layers) at their
published widths in float32 (TF32 off), with ``chip_smoke.py``'s seeded
weights: teacher-forced decode logits over ``--tokens`` random tokens
(``chip_smoke.teacher_forced_decode``, a CUDA graph of the decode step),
then the prefill logits with the SSD scan's chunk at 256 (the models'),
128, 64 and 16.  For each chunk: the largest absolute difference, the
largest ratio of a difference to the reference tolerance ``2e-4 * (1 +
|logit|)`` and the first token where that ratio passes 1.  Then the
first mixer alone (``mamba2_block`` against ``mamba2_decode`` on unit
normal input), and the graphed decode against the eager loop over the
first 100 tokens.  Prints one JSON line per arch with the card's name and
power limit; ``--out`` writes them to a file as well.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-780m", "hymba-1.5b")
CHUNKS = (256, 128, 64, 16)
TOL = 2e-4


def study(arch: str, n: int, card: str) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model

    cfg = cs.family_config(arch, None, False, "float32")
    m = build_model(cfg, device="cuda")
    p = m.init(cs.SEED)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, n))).cuda()
    out = {"arch": arch, "n_layers": cfg.n_layers, "tokens": n, "tol": TOL,
           "card": card}
    block = S.mamba2_block
    with torch.inference_mode():
        t0 = time.perf_counter()
        dec = cs.teacher_forced_decode(m, p, toks, "cuda")
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
        out["max_abs_logit"] = float(dec.abs().max())
        try:
            for chunk in CHUNKS:
                T.S.mamba2_block = functools.partial(block, chunk=chunk)
                diff = (m.forward(p, {"tokens": toks})[0] - dec).abs()
                ratio = diff / (TOL * (1 + dec.abs()))
                bad = torch.nonzero(ratio.amax(dim=1) > 1)
                out[f"chunk_{chunk}"] = {
                    "max_abs": float(diff.max()),
                    "max_ratio": float(ratio.max()),
                    "first_token_over": int(bad[0, 0]) if len(bad) else None}
        finally:
            T.S.mamba2_block = block
        out["first_mixer"] = cs.mixer_vs_recurrence(
            p["layers"][0]["ssm"], cfg, n, "cuda")
        graphed = cs.teacher_forced_decode(m, p, toks[:, :100], "cuda")
        caches = m.decode_init(1, 100)
        steps = []
        t0 = time.perf_counter()
        for t in range(100):
            logits, caches = m.decode_step(p, caches, toks[:, t:t + 1], t)
            steps.append(logits[0])
        eager = torch.stack(steps)
        torch.cuda.synchronize()
        out["eager_ms_per_step"] = (time.perf_counter() - t0) * 10
        out["graphed_ms_per_step"] = out["decode_s"] / n * 1e3
        out["graphed_vs_eager_max_abs"] = float((graphed - eager).abs().max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=600)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("ssm_decode_study: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    ops.ensure_built()
    lines = []
    for arch in ARCHS:
        lines.append(json.dumps(study(arch, args.tokens, card)))
        print(lines[-1], flush=True)
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
