"""(arch × shape) cells: the train, prefill or decode step of an
architecture at one input shape, with its inputs' shapes, on one card or
on a mesh of cards.

Mirror of ``repro.launch.cells``.  ``build_cell``'s third argument is a
device (one card: today's cells) or a ``torch.distributed``
``DeviceMesh`` (the reference's ``mesh``):

* On a device, every logical axis is replicated: a :class:`Cell` holds
  ``device`` and no shardings.
* On a mesh, the cells place their inputs as the reference's
  ``_tree_shardings`` and ``logical_to_spec`` do: parameters, the AdamW
  state (``AdamW.state_axes``) and caches by their logical axes
  (DTensors, each rank holding its block), tokens / labels / patches /
  frames by ``batch``.  The prefill step returns logits placed as
  ``("batch", None, "act_vocab")`` (decode ``("batch", "act_vocab")``);
  the train step is ``make_train_step(mesh=)``, its accumulation clamped
  to the batch over the mesh's data-parallel extent (pod x data), and
  returns the updated parameters and state in their placements.
* There is no ``lower``: a PyTorch step is not traced or compiled, so
  there is nothing to lower.  A cell is run (:meth:`Cell.run`), or
  analysed operation by operation on ``meta`` tensors
  (:func:`repro_torch.launch.step_analysis.analyze_step` over a cell
  built with ``device="meta"``).
* ``args`` are ``meta`` tensors of the full shapes, the counterpart of
  the reference's ``ShapeDtypeStruct`` trees: parameters from
  :func:`abstract_params`, the optimizer state, the batch of
  :func:`batch_specs`, caches from the model's ``decode_init``.  On a
  mesh they are DTensors of ``meta`` blocks, laid out by their logical
  axes as :meth:`Cell.inputs` lays out real ones (the reference's
  structs carry their shardings); in ``launch.mesh.abstract_world`` the
  model, too, is on ``meta``, and ``analyze_step`` counts one rank's
  step.  :meth:`Cell.inputs` makes real ones on the cell's device (or
  mesh) from a seed.
* No donation.  The reference donates params and optimizer state to the
  train step and the caches to the decode step.  Here the train step's
  AdamW writes the new parameters and moments into the tensors it is
  given (``repro_torch.optim.adamw``); the decode step returns new caches
  and leaves the ones it was given as they were
  (``models.attention.decode_attention_block``), so the caller drops the
  old ones.

``python -m repro_torch.launch.cells --arch A --shape S --mesh DxM``
runs one cell on a mesh, one process per card (a train shape prints the
step's loss):
``torchrun --nproc-per-node 4 -m repro_torch.launch.cells --arch
qwen1.5-110b --shape prefill_32k --mesh 1x4 --layers 4 --seq 4096
--batch 1`` (``--device cpu`` for a gloo world here).

The three kinds are the reference's: ``train`` (``make_train_step`` with
AdamW at ``warmup_cosine(3e-4, 100, 10_000)``, the accumulation clamped
to the batch), ``prefill`` (``model.forward``: the full (B, S,
padded_vocab) logits, as the reference's forward returns them) and
``decode`` (one ``decode_step`` of a (B, 1) int32 token at a scalar
position against caches of ``S``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ArchConfig, ShapeConfig, get_config, get_shape
from ..models.registry import ModelAPI, build_model
from ..optim import AdamW, warmup_cosine
from ..optim.adamw import tree_map
from ..sharding.axes import (distribute, local_block, mesh_device,
                             tree_zip_map)
from ..sharding.collectives import Local
from ..training import make_train_step

#: the logical axes of each batch key (the reference's ``batch_specs``)
BATCH_AXES = {"tokens": ("batch", None), "labels": ("batch", None),
              "patches": ("batch", None, None),
              "frames": ("batch", None, None)}

# per-(arch, shape) gradient-accumulation overrides, the reference's
# values (it sized them for 16 GB chips; build_cell clamps them to the
# batch)
ACCUM_OVERRIDES = {
    ("qwen1.5-110b", "train_4k"): 16,
    ("granite-20b", "train_4k"): 8,
    ("gemma3-27b", "train_4k"): 8,
    ("dbrx-132b", "train_4k"): 16,
    ("llava-next-mistral-7b", "train_4k"): 4,
    ("phi3-mini-3.8b", "train_4k"): 4,
    ("hymba-1.5b", "train_4k"): 2,
    ("mamba2-780m", "train_4k"): 2,
    ("granite-moe-1b-a400m", "train_4k"): 2,
    ("whisper-small", "train_4k"): 2,
}


class Spec(NamedTuple):
    """One input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def abstract_params(model: ModelAPI) -> Dict[str, Any]:
    """The parameter tree of ``model`` as ``meta`` tensors, without
    allocating it.  ``model.init`` draws from a ``torch.Generator`` on the
    model's device, and no generator lives on ``meta``; so the init runs
    on a CPU twin of the model under ``FakeTensorMode``, which records
    shapes and dtypes and draws nothing (the generator is left as it
    was)."""
    cpu = build_model(model.cfg, device="cpu")
    with FakeTensorMode():
        fake = cpu.init(0)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                with_labels: bool) -> Dict[str, Spec]:
    """The batch's keys, shapes and dtypes, as the reference's: audio
    gets ``frames`` (B, S, d_model) bf16 and max(S // 4, 8) tokens, a vlm
    ``patches`` (B, n_patches, d_vision) bf16 and S - n_patches tokens,
    every other family S tokens; labels are shaped like the tokens."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    out: Dict[str, Spec] = {}
    if cfg.family == "audio":
        s_txt = max(S // 4, 8)
        out["frames"] = Spec((B, S, cfg.d_model), bf16)
    elif cfg.family == "vlm":
        s_txt = S - cfg.n_patches
        out["patches"] = Spec((B, cfg.n_patches, cfg.d_vision), bf16)
    else:
        s_txt = S
    out["tokens"] = Spec((B, s_txt), i32)
    if with_labels:
        out["labels"] = Spec((B, s_txt), i32)
    return out


def make_batch(specs: Dict[str, Spec], cfg: ArchConfig, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """A batch of ``specs`` drawn with numpy from ``seed``: tokens and
    labels uniform over the vocabulary, patches and frames unit normal
    (stub embeddings)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(specs):
        shp, dtype = specs[name]
        if dtype.is_floating_point:
            a = rng.standard_normal(shp, dtype=np.float32)
        else:
            a = rng.integers(0, cfg.vocab_size, shp, dtype=np.int32)
        out[name] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return out


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ArchConfig
    step_fn: Callable
    args: tuple               # meta tensors: the step's inputs' shapes
    kind: str                 # "train" | "prefill" | "decode"
    device: torch.device
    model: ModelAPI
    shape_cfg: ShapeConfig
    accum: Optional[int] = None
    optimizer: Optional[AdamW] = None
    mesh: Any = None

    def run(self, *args):
        return self.step_fn(*args)

    def inputs(self, seed: int = 0, params=None) -> tuple:
        """Real inputs on the cell's device (a ``meta`` cell's are its
        ``args``): ``params`` (default: the model's ``init(seed)``), then
        a zero optimizer state and a batch (train), a batch (prefill), or
        caches filled from ``seed``, a (B, 1) int32 token and the position
        ``S - 1``, so that the step reads the whole cache (decode)."""
        mesh = self.mesh
        if params is None:
            params = self.model.init(seed, mesh=mesh)
        if self.kind in ("train", "prefill"):
            train = self.kind == "train"
            batch = make_batch(batch_specs(self.cfg, self.shape_cfg, train),
                               self.cfg, seed, self.device)
            if mesh is not None:
                batch = {k: distribute(v, BATCH_AXES[k], mesh)
                         for k, v in batch.items()}
            if train:
                return params, self.optimizer.init(params), batch
            return params, batch
        B, S = self.shape_cfg.global_batch, self.shape_cfg.seq_len
        caches = self.model.decode_init(B, S, mesh=mesh)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def fill(t):
            if mesh is None:
                return t.normal_(generator=gen)
            # the unsharded cell's draw, leaf by leaf, then this block
            full = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            full.normal_(generator=gen)
            t.to_local().copy_(local_block(full, t.placements, mesh))
            return t

        tree_map(fill, caches)
        token = make_batch({"t": Spec((B, 1), torch.int32)}, self.cfg, seed,
                           self.device)["t"]
        if mesh is not None:
            token = distribute(token, BATCH_AXES["tokens"], mesh)
        pos = torch.tensor(S - 1, dtype=torch.int32, device=self.device)
        return params, caches, token, pos


def _prefill_fn(model: ModelAPI, mesh=None) -> Callable:
    def prefill(params, batch):
        with torch.no_grad():
            return model.forward(params, batch, mesh)
    return prefill


def _decode_fn(model: ModelAPI, mesh=None) -> Callable:
    def decode(params, caches, token, pos):
        with torch.no_grad():
            return model.decode_step(params, caches, token, pos, mesh=mesh)
    return decode


def build_cell(arch_id: str, shape_id: str, device="cuda",
               grad_accum: Optional[int] = None,
               cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None) -> Cell:
    """The cell of ``arch_id`` × ``shape_id`` on ``device`` (default the
    card; ``"meta"`` to analyse it, ``"cpu"`` to run it here) or on a
    ``DeviceMesh``.  ``cfg`` and ``shape`` replace the registered ones (a
    depth or batch cut)."""
    cfg = cfg if cfg is not None else get_config(arch_id)
    shape = shape if shape is not None else get_shape(shape_id)
    mesh = None
    if not isinstance(device, (str, torch.device)):
        mesh, dev = device, mesh_device(device)
    else:
        dev = torch.device(device)
    model = build_model(cfg, device=dev)
    params = abstract_params(model)

    def place(tree, axes):
        # meta DTensors laid out by ``axes`` on the mesh (as is, off one)
        if mesh is None:
            return tree
        return tree_zip_map(lambda ax, t: distribute(t, ax, mesh), axes,
                            tree)

    params = place(params, model.axes())
    common = dict(arch=arch_id, shape=shape_id, cfg=cfg, kind=shape.kind,
                  device=dev, model=model, shape_cfg=shape, mesh=mesh)

    if shape.kind == "train":
        accum = grad_accum or ACCUM_OVERRIDES.get((arch_id, shape_id),
                                                  cfg.grad_accum)
        # microbatches must stay shardable over the data-parallel
        # extent (pod x data), 1 on one card
        dp_total = Local(mesh).size(("pod", "data"))
        accum = max(1, min(accum, shape.global_batch // dp_total))
        opt = AdamW(lr=warmup_cosine(3e-4, 100, 10_000))
        batch = {k: s.meta() for k, s in
                 batch_specs(cfg, shape, with_labels=True).items()}
        batch = place(batch, {k: BATCH_AXES[k] for k in batch})
        step = make_train_step(model, opt, mesh=mesh, grad_accum=accum)
        return Cell(step_fn=step, args=(params, opt.init(params), batch),
                    accum=accum, optimizer=opt, **common)

    if shape.kind == "prefill":
        batch = {k: s.meta() for k, s in
                 batch_specs(cfg, shape, with_labels=False).items()}
        batch = place(batch, {k: BATCH_AXES[k] for k in batch})
        return Cell(step_fn=_prefill_fn(model, mesh), args=(params, batch),
                    **common)

    B, S = shape.global_batch, shape.seq_len
    caches = place(build_model(cfg, device="meta").decode_init(B, S),
                   model.decode_axes())
    token = place(Spec((B, 1), torch.int32).meta(), BATCH_AXES["tokens"])
    pos = Spec((), torch.int32).meta()
    return Cell(step_fn=_decode_fn(model, mesh),
                args=(params, caches, token, pos), **common)


def main(argv=None) -> int:
    """Run one cell on a (data, model) mesh of this ``torchrun`` world
    (by default :func:`.mesh.make_production_mesh`); rank 0 prints, for
    prefill or decode, the logits' shape and placements, whether they
    are finite, and the step's milliseconds (the host clock, after a
    warm-up); for train, the two steps' losses, whether they are
    finite, and the second step's milliseconds.  A world this call
    started is closed at the end."""
    import argparse
    import time

    import torch.distributed as dist

    from ..configs import ARCH_IDS, SHAPES
    from .mesh import init_distributed, make_mesh, make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="",
                    help="data x model (default 1 x the world)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=0, help="a depth cut")
    ap.add_argument("--seq", type=int, default=0, help="a sequence cut")
    ap.add_argument("--batch", type=int, default=0, help="a batch cut")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    started = not dist.is_initialized()
    rank, _ = init_distributed(args.device)
    mesh = make_mesh(tuple(int(v) for v in args.mesh.split("x")),
                     ("data", "model")) if args.mesh else \
        make_production_mesh()
    cfg = get_config(args.arch)
    cfg = cfg.smoke() if args.smoke else cfg
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = get_shape(args.shape)
    shape = dataclasses.replace(shape, seq_len=args.seq or shape.seq_len,
                                global_batch=args.batch
                                or shape.global_batch)
    cell = build_cell(args.arch, args.shape, mesh, cfg=cfg, shape=shape)
    inputs = cell.inputs(0)
    if cell.kind == "train":
        return _train_main(cell, inputs, mesh, rank, args.device, started)
    out = cell.run(*inputs)
    logits = out[0] if cell.kind == "decode" else out
    finite = bool(torch.isfinite(logits.to_local()).all())
    if args.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell.run(*inputs)
    if args.device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if rank == 0:
        print(f"{args.arch} x {args.shape} on {tuple(mesh.shape)}: logits "
              f"{tuple(logits.shape)} {list(logits.placements)}, finite "
              f"{finite}, {ms:.2f} ms", flush=True)
    if started:
        dist.destroy_process_group()
    return 0


def _train_main(cell, inputs, mesh, rank, device, started) -> int:
    import time

    import torch.distributed as dist

    params, opt_state, batch = inputs
    params, opt_state, m1 = cell.run(params, opt_state, batch)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, m2 = cell.run(params, opt_state, batch)
    losses = [float(m1["loss"]), float(m2["loss"])]
    ms = (time.perf_counter() - t0) * 1e3
    finite = all(np.isfinite(v) for v in losses)
    if rank == 0:
        print(f"{cell.arch} x {cell.shape} on {tuple(mesh.shape)}: train "
              f"accum {cell.accum}, loss {losses[0]:.6f} -> "
              f"{losses[1]:.6f}, finite {finite}, {ms:.2f} ms", flush=True)
    if started:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
