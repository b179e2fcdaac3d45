"""Multi-pod dry run: every (arch x shape x mesh) cell's step traced once
on fake tensors over a fake process group of 256 or 512 ranks, the port of
``repro.launch.dryrun`` (which lowers and compiles each cell for 512
placeholder devices).

For each cell this gives:
  * proof that the cell's step runs on the production mesh with the
    preset's shardings (``ok``), tensor parallelism and FSDP storage
    included,
  * memory per device (``memory``; fits-or-not against the card's 80 GB),
  * per-device FLOPs, bytes and collective bytes, intra- and cross-node
    (``launch.comm_analysis``), and per stage,
  * roofline terms on the H100's datasheet constants and the MODEL_FLOPS
    ratio (``launch.roofline``).

How. Rank 0 of a ``"fake"`` process group (``FakeStore``) builds the
production mesh over it; the cell's params, optimizer state, batch and
cache are DTensors whose local shards are fake tensors
(``FakeTensorMode``) of rank 0's shape, placed by the model's shardings.
The step runs once, as a user calls it (``Model.train_step``, ``prefill``,
``decode_step`` under ``use_mesh``), under ``comm_analysis.Recorder``.
Collectives run on the fake group and move nothing; no kernel launches
(each kernel's custom op gives its output's shape and its FLOPs).
``device="cuda"`` makes fake CUDA tensors, so the step takes the card's
path, the kernels' ops included; that needs a CUDA build of torch, not a
card (a CPU-only build refuses device guards for CUDA tensors, fake ones
too). ``device="cpu"`` traces the CPU path, the kernels' plain
versions.

The reference corrects XLA's once-per-loop cost counts with unrolled
recompiles (trip-count slopes); the port runs every layer, so ``stages``
holds each stage's counts as read, forward and backward, under the
reference's stage keys (``stage_plan``).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch falcon-mamba-7b --mesh both \\
      --device cpu
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch import _tree
from repro_torch.configs import all_cells, make_run
from repro_torch.configs.base import SHAPES
from repro_torch.launch import comm_analysis as ca
from repro_torch.launch import roofline as rf
from repro_torch.models.model_zoo import Model
from repro_torch.parallel.sharding import local_shape_and_offset

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
DEVICE_BYTES = 80e9          # one H100's memory (datasheet)
PRODUCTION = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


def input_specs(arch: str, shape: str, run_overrides: Optional[dict] = None):
    """Meta-tensor stand-ins for every model input of this cell."""
    run = _make_run(arch, shape, run_overrides)
    model = Model(run)
    if run.shape.kind == "train":
        return {"params": model.abstract_params(),
                "opt_state": model.abstract_opt_state(),
                "batch": model.abstract_batch()}
    if run.shape.kind == "prefill":
        b = model.abstract_batch()
        b.pop("labels", None)
        return {"params": model.abstract_params(), "batch": b,
                "cache": model.abstract_cache()}
    return {"params": model.abstract_params(),
            "tokens": torch.empty((run.shape.global_batch,),
                                  dtype=torch.int32, device="meta"),
            "cache": model.abstract_cache()}


def stage_plan(run) -> Dict[str, int]:
    """stage key -> repeats."""
    plan = {f"stage_{i}": reps
            for i, (_, reps) in enumerate(run.model.stages())}
    if run.model.is_encoder_decoder:
        plan["enc_stage"] = run.model.n_encoder_layers
    return plan


def _make_run(arch, shape, run_overrides):
    """``make_run`` with overrides; ``model`` and ``shape`` among them
    replace the cell's config and shape profile (a reduced cell)."""
    kw = dict(run_overrides or {})
    swap = {k: kw.pop(k) for k in ("model", "shape") if k in kw}
    return make_run(arch, shape, **kw).with_(**swap)


def _shardings(model: Model, mesh, kind: str):
    """(the step's input names, their sharding trees)."""
    if kind == "train":
        return {"params": model.param_shardings(mesh),
                "opt_state": model.opt_shardings(mesh),
                "batch": model.batch_shardings(mesh)}
    sh = {"params": model.param_shardings(mesh),
          "cache": model.cache_shardings(mesh)}
    if kind == "prefill":
        b = model.batch_shardings(mesh)
        b.pop("labels", None)
        sh["batch"] = b
    else:
        sh["tokens"] = model.token_sharding(mesh)
    return sh


def _fake_dtensor(meta, sharding, device):
    """A DTensor of ``meta``'s global shape and dtype whose local shard
    (this rank's, by ``sharding``) is an empty fake tensor."""
    from torch.distributed.tensor import DTensor
    local, _ = local_shape_and_offset(meta.shape, sharding.device_mesh,
                                      sharding.placements)
    t = torch.empty(local, dtype=meta.dtype, device=device)
    return DTensor.from_local(t, sharding.device_mesh,
                              list(sharding.placements), run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _local_bytes(tree) -> int:
    return sum(x.to_local().numel() * x.to_local().element_size()
               if hasattr(x, "to_local") else x.numel() * x.element_size()
               for x in _tree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _trace(model: Model, mesh, kind, specs, device):
    """Build the fake inputs, run the step once under a recorder; (the
    recorder, argument bytes, output bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import use_mesh
    sh = _shardings(model, mesh, kind)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    rec = ca.Recorder([mesh.device_mesh], fake)
    with fake:
        args = {k: _tree.tree_map(lambda m, s: _fake_dtensor(m, s, device),
                                  specs[k], sh[k]) for k in sh}
        arg_bytes = _local_bytes(args)
        tfm.STAGE_OBSERVERS.append(rec.observe_stage)
        try:
            with use_mesh(mesh), rec:
                if kind == "train":
                    out = model.train_step(args["params"], args["opt_state"],
                                           args["batch"])
                elif kind == "prefill":
                    out = model.prefill(args["params"], args["batch"],
                                        args["cache"])
                else:   # the last position: the step's work is the same
                    out = model.decode_step(args["params"], args["tokens"],
                                            args["cache"],
                                            pos=model.run.shape.seq_len - 1)
        finally:
            tfm.STAGE_OBSERVERS.remove(rec.observe_stage)
        out_bytes = _local_bytes(out)
    return rec, arg_bytes, out_bytes


def run_cell(arch: str, shape: str, mesh_kind: str, *, device="cuda",
             run_overrides: Optional[dict] = None,
             mesh_shape: Optional[Dict[str, int]] = None) -> dict:
    """One cell's record. ``mesh_shape`` replaces the production mesh's
    axis sizes (``PRODUCTION[mesh_kind]``), for a small world."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": False,
           "device": device}
    t_start = time.time()
    try:
        run = _make_run(arch, shape, run_overrides)
    except ValueError as e:   # inapplicable cell (long_500k on full attention)
        rec.update(skipped=True, reason=str(e))
        return rec
    axes = dict(mesh_shape or PRODUCTION[mesh_kind])
    chips = math.prod(axes.values())
    try:
        if device == "cuda" and not torch.backends.cuda.is_built():
            raise RuntimeError("fake CUDA tensors need a CUDA build of "
                               "torch (not a card); use --device cpu")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=chips)
        try:
            mesh = make_mesh(tuple(axes.values()), tuple(axes), device)
            model = Model(run)
            recd, arg_bytes, out_bytes = _trace(
                model, mesh, run.shape.kind,
                input_specs(arch, shape, run_overrides), device)
        finally:
            dist.destroy_process_group()
        coll = ca.collective_bytes(recd.collectives)
        span = ca.collective_bytes_by_span(recd.collectives)
        rec["memory"] = {"argument_bytes": arg_bytes,
                         "output_bytes": out_bytes,
                         "temp_bytes": recd.peak,
                         "device_bytes": DEVICE_BYTES,
                         "fits": arg_bytes + recd.peak <= DEVICE_BYTES}
        rec["collectives"] = coll
        rec["collective_span"] = dict(span, node_size=rf.NODE_SIZE)
        rec["kernel_flops"] = dict(recd.kernel_flops)
        flops, byts = recd.flops, recd.bytes
        rec["per_device"] = {"flops": flops, "bytes": byts,
                             "collective_bytes": coll["total"],
                             "bytes_note": "sum of each op's local input "
                                           "and output bytes, unfused: an "
                                           "upper bound"}
        rec["stages"] = {key: dict(recd.by_stage.get(key, {}), reps=reps)
                         for key, reps in stage_plan(run).items()}
        rec["chips"] = chips
        rec["roofline"] = rf.roofline_terms(flops, byts, coll["total"])
        mf = rf.model_flops(run.model, run.shape)
        rec["model_flops"] = mf
        rec["hlo_flops_global"] = flops * chips
        rec["model_vs_hlo"] = mf / (flops * chips) if flops else 0.0
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=40)
    rec["wall_s"] = round(time.time() - t_start, 1)
    return rec


def save(rec: dict, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json".replace("/", "-")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def status_line(rec: dict) -> str:
    """The reference's one line per cell."""
    if rec.get("skipped"):
        status = "SKIP (" + rec["reason"][:60] + ")"
    elif rec["ok"]:
        r = rec["roofline"]
        status = (f"ok {rec['wall_s']:6.1f}s  dominant={r['dominant']}"
                  f" bound={r['bound_s']*1e3:.1f}ms"
                  f" model/hlo={rec['model_vs_hlo']:.2f}")
    else:
        status = "FAIL " + rec["error"][:110]
    return f"[{rec['arch']:>20s} x {rec['shape']:<11s} x {rec['mesh']:<6s}] " \
        + status


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a, s, _, _ in all_cells(include_inapplicable=True)]
    else:
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in ([args.arch] if args.arch else [])
                 for s in shapes]
    n_fail = 0
    for arch, shape in cells:
        for mk in meshes:
            fname = os.path.join(
                args.out, f"{arch}_{shape}_{mk}.json".replace("/", "-"))
            if args.skip_existing and os.path.exists(fname):
                with open(fname) as f:
                    old = json.load(f)
                if old.get("ok") or old.get("skipped"):
                    print(f"[{arch:>20s} x {shape:<11s} x {mk:<6s}] cached",
                          flush=True)
                    continue
            rec = run_cell(arch, shape, mk, device=args.device)
            save(rec, args.out)
            n_fail += not (rec["ok"] or rec.get("skipped"))
            print(status_line(rec), flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
