"""End-to-end trainer.

Mirror of ``repro.launch.train``: config -> mesh -> model -> sharded
parameters and optimizer -> curated data pipeline -> train loop with
heartbeats, straggler tracking, async checkpointing and
checkpoint-restart.  The reference's flags, plus ``--device`` (default
``cuda``).  On the card every layer's attention runs the hand-written
flash kernel in the forward (and again in the remat recompute); its
gradient is plain PyTorch.

Under ``torchrun`` (a world of more than one process) :func:`main`
builds the reference's host mesh (:func:`.mesh.make_host_mesh`: (2, 2)
on 4 processes, (1, 2) on 2), places the parameters and the AdamW state
by ``ModelAPI.axes`` / ``AdamW.state_axes``, each batch by
:data:`.cells.BATCH_AXES`, and trains with ``make_train_step(mesh=)``.
Every rank draws the same batches; rank 0 alone prints, beats the
heartbeat and writes the checkpoints (every rank takes part in their
gather), as in the reference's single-host simulation of the fleet
services.  One process keeps the unsharded path, with no mesh.  (The
reference's ``main`` always builds a mesh, of one device on one.)

:func:`main` parses the flags and calls :func:`train`, which callers
may call themselves with a config of their own (a cut depth),
parameters of their own and a mesh of their own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-20b \\
      --smoke --steps 50 --curation balance [--device cpu]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \\
      granite-20b --smoke --steps 50
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import CurationFilter, Pipeline, SyntheticTokenStream
from ..models.registry import build_model, shard_params
from ..optim import AdamW, warmup_cosine
from ..runtime import HeartbeatRegistry, StragglerDetector
from ..sharding.axes import distribute, mesh_device, sharding_tree
from ..training import make_train_step
from .cells import BATCH_AXES


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--curation", default="off",
                    choices=["off", "balance", "dedup", "novelty"])
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--d-model-override", type=int, default=0)
    ap.add_argument("--preset", default=None, choices=[None, "100m"],
                    help="'100m': a ~124M-param granite-family config "
                         "(12L x 768, vocab 32k) for real-hardware runs")
    return ap.parse_args(argv)


def config_of(args: argparse.Namespace):
    """The architecture config the flags describe."""
    cfg = get_config(args.arch)
    if args.preset == "100m":
        cfg = dataclasses.replace(
            cfg, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32000, grad_accum=1,
        )
    elif args.smoke:
        cfg = cfg.smoke()
    if args.d_model_override:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model_override,
            head_dim=args.d_model_override // max(cfg.n_heads, 1) or None,
        )
    return cfg


def train(cfg, args: argparse.Namespace, params=None,
          mesh=None) -> List[Dict]:
    """Train ``cfg`` as the flags ``args`` say, from ``params`` (drawn by
    ``init(0)`` when None; updated in place), on ``mesh`` if one is given
    (a ``DeviceMesh`` over ``(data, model)``: full ``params`` are placed
    on it); returns each step's ``{"step", "loss", "grad_norm",
    "seconds"}`` (seconds from the batch on the device to the loss on
    the host)."""
    dev = args.device if mesh is None else mesh_device(mesh)
    model = build_model(cfg, device=dev)
    lead = mesh is None or mesh.get_rank() == 0

    def say(*a):
        if lead:
            print(*a, flush=True)

    where = "" if mesh is None else \
        f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    say(f"arch={cfg.name} params≈{cfg.n_params()/1e6:.1f}M "
        f"device={model.device}{where}")

    if params is None:
        params = model.init(0, mesh=mesh)
    elif mesh is not None:
        params = shard_params(params, model.axes(), mesh)
    opt = AdamW(lr=warmup_cosine(args.lr, 20, max(args.steps, 100)))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, mesh=mesh,
                              grad_accum=args.grad_accum)

    # data
    src = SyntheticTokenStream(cfg.vocab_size, args.seq, args.batch, seed=1)
    curation = None
    if args.curation != "off":
        curation = CurationFilter(d=src.embed_dim, k=8, t=8, eps=0.6,
                                  policy=args.curation, window=20_000)
    pipe = Pipeline(iter(src), curation=curation)

    # runtime services (single-host simulation of the fleet services)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep_n=2,
                             host_id=0 if lead else mesh.get_rank())
    hb = HeartbeatRegistry(n_hosts=1, timeout_s=300)
    sd = StragglerDetector(n_hosts=1)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        template = {"params": params, "opt": opt_state}
        shardings = None if mesh is None else sharding_tree(
            {"params": model.axes(),
             "opt": opt.state_axes(model.axes())}, template, mesh)
        state = ckpt.restore(template, shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        start = ckpt.latest_step()
        say(f"resumed from step {start}")

    steps: List[Dict] = []
    try:
        for step in range(start, args.steps):
            batch = next(pipe)
            t0 = time.time()
            tb = {k: torch.from_numpy(v).to(model.device, torch.long)
                  for k, v in batch.items()
                  if k in ("tokens", "labels")}
            if mesh is not None:
                tb = {k: distribute(v, BATCH_AXES[k], mesh)
                      for k, v in tb.items()}
            params, opt_state, metrics = step_fn(params, opt_state, tb)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            steps.append({"step": step, "loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "seconds": dt})
            if lead:
                hb.beat(0, step)
                sd.record(0, dt)
            if step % 5 == 0 or step == args.steps - 1:
                kept = (f" kept={curation.n_kept}/{curation.n_seen}"
                        if curation else "")
                say(f"step {step:4d} loss={loss:.4f} "
                    f"gnorm={steps[-1]['grad_norm']:.3f} "
                    f"dt={dt*1e3:.0f}ms{kept}")
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
        ckpt.wait()
    finally:
        pipe.close()
    if steps:
        say(f"final loss {steps[-1]['loss']:.4f} "
            f"(first {steps[0]['loss']:.4f})")
    return steps


def main(argv=None) -> List[float]:
    """Parse the flags and train; returns the losses, as the
    reference's ``main`` does.  In a world of several processes
    (``torchrun``'s ``WORLD_SIZE``) on the host mesh, which a world this
    call started closes at the end."""
    import torch.distributed as dist

    from .mesh import init_distributed, make_host_mesh

    args = parse_args(argv)
    mesh, started = None, False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or (
            dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        started = not dist.is_initialized()
        init_distributed(args.device)
        mesh = make_host_mesh()
    try:
        return [m["loss"] for m in train(config_of(args), args, mesh=mesh)]
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
