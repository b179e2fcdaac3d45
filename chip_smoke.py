#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (CUDA_HOME, default /usr/local/cuda) and the
checkout's ``src/``; it builds every kernel from the sources at first use.
Phases, each of which fails the run (non-zero exit) on a failed check, with
each phase's wall time printed:

  1. print the card (name, power limit) and build both kernels (flash
     attention, selective scan), one nvcc each, in parallel, timed, with
     ptxas's registers and spills;
  2. hold each kernel against its plain PyTorch version on the card, over
     the reference's test sweep, a ragged case and the serve paths'
     shapes, each on the body the wrapper picks, with times for the
     kernel, the plain version, one PyTorch library call computing the
     same function (where there is one), and the bound (least time the
     card could take); flash attention's mma.sync body forced on the serve
     shape beside its tma body; both kernels at the serve profile's full
     2048-token prompt; each timed kernel's device time from
     torch.profiler beside its CUDA-event time, and the host us per
     wrapper call;
  3. serve tinyllama-1.1b at its full config (22 layers, d_model 2048,
     bf16, random weights from a seed) through
     ``repro_torch.launch.serve.Server`` and the port's EmeraldRuntime,
     with the cloud tier on the card: 8 requests of 384-512 prompt tokens,
     32 new tokens each. Kernel launch counts (flash attention's also by
     body) are reset just before and read just after;
  4. run the same model at 2 layers, full width, on the card (bf16, kernel)
     and on the CPU (f32, plain version) from one param tree, and compare
     the logits;
  3b. serve falcon-mamba-7b at full width, 32 of its 64 Mamba layers
     (d_model 4096, bf16, random weights from a seed) the same way: 4
     requests in one batch; every prefill launches the selective scan
     once per layer;
  4b. falcon-mamba at 2 layers, full width, card against CPU, as phase 4;
  5. the paper's adjoint-tomography workflow (``repro_torch.apps``) at the
     Fig 11 and Fig 12 meshes (nt=200, 16 receivers, f32) through
     EmeraldExecutor twice: policy "never" (all four steps on the host
     CPU) and "annotate" (steps 2-4 offloaded to the card), from the same
     observations and starting model, one warm-up and 3 timed iterations
     each; seconds per iteration, per-step exec seconds, offloads and MDSS
     bytes per arm, the measured reduction, and the two arms held equal
     (chi and the final model at rtol 1e-5, the final models bitwise, 9
     offloads, obs shipped once);
  6. the Fig 11 offloaded arm again with a ``Fabric(workers=2)`` behind
     the cloud tier: the device steps stay on the card, MDSS staging
     crosses worker processes; results bitwise those of phase 5, the same
     MDSS bytes, a registry step in a worker, no worker left afterwards;
  7. ``FrontDoor`` in front of tinyllama-1.1b (full config, bf16) on the
     card: 16 client threads, 64 requests of a 128-token window each,
     coalesced into fused forwards that launch the flash kernel once per
     layer; every row held against its window run alone;
  8. train tinyllama-1.1b at its full config through
     ``repro_torch.launch.train.Trainer`` (an Emerald workflow whose
     ``train_step`` is offloaded to the card): 2048 tokens x 4 sequences,
     remat "full", 2 microbatches, AdamW with f32 state, 3 steps (a
     warm-up, a timed step and a timed step under torch.profiler); flash
     attention launches 22 layers x 2 (forward, recompute) x 2
     microbatches per step, all on the tma body; after the first step only
     the batch crosses to the card; s/step, tokens/s, ship/exec/install
     per step, peak device bytes and the device's idle share;
  8b. the same for falcon-mamba-7b at full width (d_model 4096, d_inner
     8192, N 16, bf16) and 8 of its 64 layers (the whole model with AdamW
     f32 state needs ~87 GB), 1024 tokens x 2: the selective scan launches
     8 x 2 per step;
  9. one train step of each arch at 2 layers, full width, f32, from one
     param tree, on the card (f32 kernel bodies) against the CPU (plain
     versions): loss rtol 1e-4, grad_norm rtol 1e-3, every updated leaf
     within 2 lr_1;
  2b. (run after phase 2) flash attention at every call of the model
     zoo's serve and train paths (phases 10-11), built from their configs:
     MLA's dq != dv (minicpm3 96/64, deepseek-v3 192/128), MLA's and
     cross-attention's serve shapes also on the mma and f32 bodies,
     seamless's non-causal encoder, causal decoder and cross-attention
     (Sq != Skv), the reduced f32 train configs' shapes; the scan at each
     hybrid path's shape;
  10a-e. serve internvl2-1b and minicpm3-4b at their full configs,
     qwen2-moe-a2.7b at 8 of 24 layers, jamba-v0.1-52b at 8 of 32
     layers and deepseek-v3-671b at 4
     of 61 (3 dense, 1 MoE) through the Server as phase 3 does: 2
     requests, 8 new tokens each; jamba's prefill launches both kernels;
  10f. serve seamless-m4t-medium (full config) through ``Model.prefill``
     and ``decode_step`` on the card, as the JAX package can (its Server
     feeds no encoder frames);
  11a-f. train through the Trainer, 2 steps each: internvl2-1b and
     seamless-m4t-medium full, minicpm3-4b at 8 layers, qwen2-moe-a2.7b
     at 2 layers, jamba and deepseek-v3 at their reduced configs (one of
     their MoE layers at full width, with its gradient and AdamW state,
     does not fit one card);
  12. the six new families at their reduced configs, f32, card against
     CPU: prefill and 2 decode steps' logits within 1e-4, one train step
     at phase 9's bounds;
  13. every shape key (shape, dtype, causality, kv_len, body; the scan's
     B/C row stride) that a main path (phases 3, 3b, 7, 8, 8b, 10, 11)
     gave a kernel is held against the plain version: those the plan
     above did not check (a second serve batch's prompt length, a
     FrontDoor flush's rows) are checked here, and a key left unchecked
     fails the run;
  16. (run before phase 13) multi-device training on the card. 16a: a
     world-1 NCCL process group and a (pod 1, data 1, model 1) mesh;
     tinyllama-1.1b at its full config, phase 8's train shape (2048 x 4)
     in one batch, the same seeded params, AdamW f32 state and batch: the
     plain ``Model.train_step``, then ``multipod_train_step`` with the
     ``none``, ``bf16`` and ``int8`` wire formats and
     ``pipeline_train_step(n_micro=2)``, each held against the plain step
     (loss within 1e-3, the pipeline's xent within 2e-3, ``none``'s loss
     within rel 1e-4, every run's grad_norm within rel 1e-4, bf16's 2^-7,
     int8's 1e-2, params within one AdamW step's reach), with s/step,
     peak device GB, flash launches and shape keys, and the bytes handed
     to collectives by op and dtype (int8's all-gather: the int8 tensors
     and f32 scales only). 16b: those params saved from that mesh and
     restored onto ``make_host_mesh()`` with the fsdp placements, every
     leaf bitwise, the metadata equal. 16c: two gloo processes on cuda:0
     (``chip_smoke.py --rank16c``): int8 over (pod 2) on reduced
     tinyllama, and qwen2-moe-a2.7b at full width, 2 of 24 layers, over
     (data 2) with ``moe_impl="manual_ep"`` (the experts exchanged by
     ``all_to_all``, AdamW bf16 state so that two fit one card), each
     against the plain step on the card;
  17. (run after phase 16, before phase 13) tensor parallelism, FSDP
     storage and the dry run. 17a: which functional collectives gloo
     carries for CUDA tensors (one pair of processes per collective);
     the plain train step, prefill (256 tokens) and 4 greedy decode steps
     of full tinyllama-1.1b (2048 x 2, AdamW f32) in this process, then
     two ``chip_smoke.py --rank17a`` processes over gloo on cuda:0 run the
     same on DTensor-placed trees in two layouts, (data 1, model 2)
     ``dp_tp`` and (data 2, model 1) ``fsdp``, each held against the
     plain steps (loss rel 2e-3, grad_norm rel 3e-2, params within one
     AdamW step's reach, logits at phase 4's bounds, teacher-forced with
     the plain tokens), with flash launched 66 times per process at the
     local shapes (phase 13 holds each), s/step, serve s and peak GB.
     17b: the dry run (``repro_torch.launch.dryrun.run_cell``) of
     tinyllama-1.1b and falcon-mamba-7b x train_4k, prefill_32k,
     decode_32k x (data 16, model 16) and (pod 2, data 16, model 16) on
     fake CUDA tensors over a fake process group: one line per cell as
     the reference's ``main()`` prints it and its record; a cell not
     ``ok``, or a train or prefill cell whose kernel FLOPs read 0, fails
     the run;
  15. (run after phase 13) the explorer's dispatch seam driving the real
     runtime on the card: one EmeraldRuntime (cloud tier on the card,
     ``max_workers=2``) takes three tenants' adjoint-tomography
     iterations at Fig 11 (phase 5's observations and starting model,
     policy "annotate") under a last-submitted-first ``dispatch_hook`` and
     then a seeded pick (``random.Random``); each tenant's misfit and
     updated model equal a solo run's bitwise; per tenant the hook calls,
     offloads, bytes up and down and wall time; the runtime's live
     ``introspect()`` snapshot rendered by ``repro_torch.tools.emtop``;
  14. (run last) the sanitizer's summary. Every path through the Emerald
     runtime (phases 3, 3b, 5's four arms, 6, 7, 8, 8b, 10a-e, 11a-f and
     15's runs) runs inside ``repro_torch.analysis.sanitizer.
     record_submissions()``: when the path ends, before its memory is
     freed, each run's event log (H101-H103) and each store's replica log
     (H110-H111) are replayed, and the runs, events, installs logged out
     of ``installs_total`` (H111 is judged only on an untrimmed log),
     findings and the verifier rule ids admission attached are printed.
     A finding fails the run at its path; phase 14 fails unless every
     one of those paths was replayed.

Phase 2 also holds each kernel at the train shapes (flash B=2, S=2048,
H=32, KV=4, d=64; the scan Bt=2, L=1024, di=8192, N=16; bf16), forward
against its plain version and the ``autograd.Function``'s backward on the
card against the same Function's on the CPU.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA data-sheet peaks of one H100 SXM (dense, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# exponentials on the special-function units: 16 per clock per SM, 132
# SMs, at the H100 SXM's 1980 MHz boost clock (data sheet)
SFU_EXP_PER_S = 16 * 132 * 1.98e9
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H_TOL = 2e-4            # the selective scan's h_last (tests/test_kernels.py)
# logits of a 2-layer full-width model, bf16 on the card vs f32 on the
# CPU: bf16 keeps ~3 significant digits per rounding, so a norm-wise
# relative error of a few 1e-3 is expected; 5e-2 fails only a real fault
LOGITS_REL_TOL = 5e-2
ARGMAX_AGREE_MIN = 0.75
LONG_PROMPT = 2048      # the serve profile's full prompt (ShapeProfile)
AT_ITERS = 3            # timed adjoint-tomography iterations per arm
AT_RTOL = 1e-5          # local vs offloaded (tests/test_at.py)
FD_REQUESTS, FD_CLIENTS, FD_WINDOW = 64, 16, 128
TENANT_SEED = 0         # phase 15's seeded dispatch hook
# FrontDoor rows (bf16 logits, batched) against the same window alone:
# the bf16 bounds PERF.md uses card against CPU
FD_REL_TOL = 2e-2
TRAIN_STEPS = 3         # a warm-up, a timed step, a timed profiled step
# Depth cuts. The whole script must end within 1200 s (the card's run
# limit); with phase 17 it took 855.341 s, and 1167.093 s on a slower host
# (every phase 1.2-1.9x longer; NVIDIA H100 80GB HBM3, 700.00 W),
# before phase 17b ran beside 17a. To make room for phase 17 three paths
# run shallower than before it. What each cut saves is at most the phase's
# time at the cut depth scaled by the layers removed (its fixed costs do
# not scale; PERF.md §5):
# falcon-mamba-7b train 8 -> 4 layers (phase 8b, 42.5 s), qwen2-moe-a2.7b
# serve 24 -> 8 (10b, 32.6 s), minicpm3-4b train 16 -> 8 (11c, 31.6 s).
MAMBA_TRAIN_LAYERS = 4  # of 64: the whole 7.3 B model with AdamW f32 state
#                         needs ~87 GB for params, grads and state
FRAMING_MAX = 64 * 1024  # bytes beside the batch a later step may ship up
# one f32 train step card vs CPU: the loss sums ~1e5 f32 terms in another
# order; grad_norm sums the squares of ~1e8-1e9 gradient entries, each a
# long f32 reduction; an AdamW first step moves a leaf by lr_1 times ~1, so
# a sign flip of a near-zero gradient moves it by at most 2 lr_1
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 1e-4, 1e-3


class CheckFailed(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise CheckFailed(msg)
    print(f"  ok: {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_us(fn, iters=200):
    """Host time of one call: the wrapper's checks, allocation and launch,
    without waiting for the card (the launches queue up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def profiled_ms(fn, pattern=None, iters=10):
    """Device time per call from torch.profiler's key_averages(): of the
    kernels whose name holds ``pattern``, or of every kernel the call
    launches when ``pattern`` is None. None where the trace holds no device
    time for them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if pattern is None:
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
        elif pattern not in e.key:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        total += us
    return total / iters / 1e3 if total > 0 else None


# ------------------------------------------------------------ flash attention
FA_KERNEL_NAMES = {"tma": "fa_fwd_tma", "mma": "fa_fwd_mma",
                   "f32": "fa_fwd_f32"}


def fa_bound_ms(B, Sq, Skv, H, KV, dq, dv, dtype, causal, kv_len):
    """Least time for the call: bytes of q, k, v read once and o written
    once over HBM bandwidth, or the visible (q, k) pairs' two products
    over the peak rate of the inputs' type; the larger bounds it."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (B * Sq * H * dq + B * Skv * KV * (dq + dv)
                      + B * Sq * H * dv)
    from repro_torch.kernels.flash_attention.ops import flops
    ops = flops(B, Sq, H, dq, dv, causal, Skv if kv_len is None else kv_len)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fa_case(B, S, H, KV, dq, dv, dtype_name, causal, kv_len=None,
            body=None, profiled=False, Skv=None):
    """Kernel vs plain version on one seeded input, both timed; returns
    the record. ``body`` forces a body (default: the one ``_body`` picks);
    ``profiled`` adds the profiler's device time and the host us per
    wrapper call; ``Skv`` (default ``S``) is the keys' length."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref
    dt = getattr(torch, dtype_name)
    Skv = S if Skv is None else Skv
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, S, H, dq), generator=g).to("cuda", dt)
    k = torch.randn((B, Skv, KV, dq), generator=g).to("cuda", dt)
    v = torch.randn((B, Skv, KV, dv), generator=g).to("cuda", dt)
    scale = dq ** -0.5
    body = body or kernel._body(q, k, v)

    def run():
        return kernel._flash_attention_fwd(q, k, v, scale=scale,
                                           causal=causal, kv_len=kv_len,
                                           body=body)
    before = kernel.launches_by_body[body]
    out = run()
    want = ref.attention_ref(q, k, v, scale=scale, causal=causal,
                             kv_len=kv_len)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    tol = TOL[dtype_name]
    good = bool(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol)
                and kernel.launches_by_body[body] == before + 1)
    CHECKED["flash_attention_fwd"].add(fa_key(
        B, S, Skv, H, KV, dq, dv, dtype_name, causal, kv_len, body))
    rec = {"shape": [B, S, H, KV, dq, dv], "dtype": dtype_name,
           "causal": causal, "kv_len": kv_len, "body": body,
           "max_abs_err": err, "tol": tol, "ok": good}
    if Skv != S:
        rec["Skv"] = Skv
    rec["ms"] = cuda_ms(run)
    rec["plain_ms"] = cuda_ms(lambda: ref.attention_ref(
        q, k, v, scale=scale, causal=causal, kv_len=kv_len))
    rec["library_ms"] = None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kv_len is None:    # SDPA takes dv != dq (on its math backend)
        rec["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale,
                enable_gqa=KV != H))
    rec["bound_ms"], rec["bound_by"] = fa_bound_ms(
        B, S, Skv, H, KV, dq, dv, dtype_name, causal, kv_len)
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    if profiled:
        rec["profiler_ms"] = profiled_ms(run, FA_KERNEL_NAMES[body])
        rec["library_profiler_ms"] = profiled_ms(lambda: (
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           scale=scale, enable_gqa=KV != H)))
        rec["host_us_per_call"] = host_us(run)
    return rec


def grads_agree(card, cpu, tol):
    """(max abs err, ok): every cotangent finite and within ``tol``
    relative and ``tol`` times the CPU's scale (its rms, at least 1)
    absolute. A gradient is a sum of terms as large as the gradient
    itself, so f32 sums in another order round relative to that scale,
    not to an element that cancels to near zero."""
    import torch
    err = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    ok = all(bool(torch.isfinite(a).all()) and torch.allclose(
        a, b, atol=tol * max(1.0, float(b.square().mean().sqrt())),
        rtol=tol) for a, b in zip(card, cpu))
    return err, ok


def backward_check(fn, host, cot, tol):
    """An ``autograd.Function``'s input cotangents on the card against the
    same Function's on the CPU, from the same host inputs ``host`` and
    output cotangents ``cot`` (``grads_agree`` at ``tol``); and the card's
    forward+backward time (CUDA events)."""
    import torch

    def grads(device):
        args = [t.to(device).requires_grad_() for t in host]
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(outs, args, [c.to(device) for c in cot])
    card = [t.float().cpu() for t in grads("cuda")]
    cpu = [t.float() for t in grads("cpu")]
    err, ok = grads_agree(card, cpu, tol)
    return {"bwd_max_abs_err": err, "bwd_tol": tol, "bwd_ok": ok,
            "fwd_bwd_ms": cuda_ms(lambda: grads("cuda"), iters=3,
                                  warmup=1)}


def fa_backward(B, S, H, KV, D, dtype_name, causal=True):
    """``backward_check`` of the flash Function at one shape: kernel
    forward and the plain version's VJP on the card, plain forward and
    VJP on the CPU, in the same dtype and the forward's tolerance."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(S + H + 7)
    host = [torch.randn(s, generator=g).to(dt) for s in
            ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    cot = [torch.randn((B, S, H, D), generator=g).to(dt)]
    return backward_check(lambda q, k, v: ops.flash_attention(
        q, k, v, scale=D ** -0.5, causal=causal), host, cot,
        TOL[dtype_name])


def phase_flash(serve_shape, train_shape):
    import torch
    cases = []
    # the reference's sweep (tests/test_kernels.py)
    for (B, H, KV, S, D) in [(1, 2, 2, 128, 128), (2, 4, 2, 256, 128),
                             (1, 8, 2, 128, 128), (1, 2, 1, 384, 128)]:
        for dt in ("float32", "bfloat16"):
            for causal in (True, False):
                cases.append(dict(B=B, S=S, H=H, KV=KV, dq=D, dv=D,
                                  dtype_name=dt, causal=causal))
    for dt in ("float32", "bfloat16"):
        cases.append(dict(B=1, S=200, H=2, KV=1, dq=96, dv=96,
                          dtype_name=dt, causal=True))
        cases.append(dict(B=1, S=128, H=2, KV=2, dq=128, dv=128,
                          dtype_name=dt, causal=False, kv_len=70))
    B, S, H, KV, D = serve_shape
    cases.append(dict(B=B, S=S, H=H, KV=KV, dq=D, dv=D, dtype_name="float32",
                      causal=True))
    recs = []
    for c in cases:
        rec = fa_case(**c)
        recs.append(rec)
        print("  flash_attention_fwd " + json.dumps(rec), flush=True)
    serve = dict(B=B, S=S, H=H, KV=KV, dq=D, dv=D, dtype_name="bfloat16",
                 causal=True, profiled=True)
    slice_rec = fa_case(**serve)
    print("  flash_attention_fwd (serve shape) " + json.dumps(slice_rec),
          flush=True)
    mma_rec = fa_case(**serve, body="mma")
    print("  flash_attention_fwd (serve shape, mma.sync body) "
          + json.dumps(mma_rec), flush=True)
    long_rec = fa_case(**dict(serve, S=LONG_PROMPT))
    print("  flash_attention_fwd (full prompt) " + json.dumps(long_rec),
          flush=True)
    B, S, H, KV, D = train_shape
    train_rec = fa_case(B=B, S=S, H=H, KV=KV, dq=D, dv=D,
                        dtype_name="bfloat16", causal=True, profiled=True)
    train_rec.update(fa_backward(B, S, H, KV, D, "bfloat16"))
    print("  flash_attention_fwd (train shape, with the Function's "
          "backward) " + json.dumps(train_rec), flush=True)
    bwd = [fa_backward(1, 256, 8, 2, 128, dt) for dt in ("float32",
                                                          "bfloat16")]
    print("  flash_attention backward (sweep case, f32 and bf16) "
          + json.dumps(bwd), flush=True)
    torch.cuda.synchronize()
    every = recs + [slice_rec, mma_rec, long_rec, train_rec]
    bad = [r for r in every if not r["ok"]]
    check(not bad, f"flash_attention_fwd agrees with attention_ref on "
          f"{len(every)} cases (f32 2e-5, bf16 2e-2)"
          + (f"; failing: {bad}" if bad else ""))
    bad = [r for r in [train_rec] + bwd if not r["bwd_ok"]]
    check(not bad, "the flash Function's backward on the card agrees with "
          "the CPU's (train shape bf16; a sweep case f32 and bf16)"
          + (f"; failing: {bad}" if bad else ""))
    check(slice_rec["body"] == long_rec["body"] == train_rec["body"]
          == "tma"
          and all(r["body"] == ("f32" if r["dtype"] == "float32" else "tma")
                  for r in recs),
          "every bf16 case ran the tma body, every f32 case the f32 body")
    slice_rec["mma_body"] = {k: mma_rec[k] for k in (
        "ms", "profiler_ms", "host_us_per_call", "max_abs_err")}
    return slice_rec, long_rec, train_rec


# ------------------------------------------------------------- selective scan
def ss_bound_ms(Bt, L, di, N, dtype):
    """Least time for the call: x, dt, A, B, C, D, h0 read once and y,
    h_last written once over HBM bandwidth, or the Bt*L*di*N
    exponentials over the special-function units' rate (the recurrence's
    ~4 f32 FLOPs per exponential at 67 TFLOP/s take less); the larger
    bounds it."""
    es = 2 if dtype == "bfloat16" else 4
    nbytes = (es * (2 * Bt * L * di + 2 * Bt * L * N)      # x, y; B, C
              + 4 * (Bt * L * di + di * N + di + 2 * Bt * di * N))
    from repro_torch.kernels.mamba_scan.ops import flops
    exps = Bt * L * di * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(exps / SFU_EXP_PER_S, flops(Bt, L, di, N)
                / PEAK_FLOPS["float32"]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ss_case(Bt, L, di, N, dtype_name, proj_width=None, timed=False):
    """Kernel vs plain version on one seeded input (the reference's
    ``_scan_args`` draws; x, B, C in the dtype, dt, A, D, h0 f32). With
    ``proj_width``, B and C are slices of one (Bt, L, proj_width) tensor,
    as the model's x_proj output. Returns the record."""
    import torch
    from repro_torch.kernels.mamba_scan import kernel, ref
    dt_ = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(L + di)
    x = torch.randn((Bt, L, di), generator=g, device="cuda").to(dt_)
    dt = torch.empty((Bt, L, di), device="cuda").uniform_(1e-3, 0.1,
                                                          generator=g)
    A = -torch.empty((di, N), device="cuda").uniform_(0.5, 2.0, generator=g)
    if proj_width:
        proj = torch.randn((Bt, L, proj_width), generator=g,
                           device="cuda").to(dt_)
        r = proj_width - 2 * N
        B, C = proj[..., r:r + N], proj[..., r + N:]
    else:
        B = torch.randn((Bt, L, N), generator=g, device="cuda").to(dt_)
        C = torch.randn((Bt, L, N), generator=g, device="cuda").to(dt_)
    D = torch.randn((di,), generator=g, device="cuda")
    h0 = torch.randn((Bt, di, N), generator=g, device="cuda")
    args = (x, dt, A, B, C, D, h0)
    y, h = kernel.selective_scan_fwd(*args)
    y_ref, h_ref = ref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype_name]
    err = (y.float() - y_ref.float()).abs().max().item()
    h_err = (h - h_ref).abs().max().item()
    good = bool(torch.allclose(y.float(), y_ref.float(), atol=tol, rtol=tol)
                and torch.allclose(h, h_ref, atol=H_TOL, rtol=0))
    CHECKED["selective_scan_fwd"].add((Bt, L, di, N, dtype_name,
                                       B.stride(1)))
    rec = {"shape": [Bt, L, di, N], "dtype": dtype_name,
           "strided_bc": bool(proj_width), "max_abs_err": err,
           "h_max_abs_err": h_err, "tol": tol, "h_tol": H_TOL, "ok": good}
    # no single PyTorch call computes a selective scan
    rec["library_ms"] = None
    rec["bound_ms"], rec["bound_by"] = ss_bound_ms(Bt, L, di, N, dtype_name)
    if timed:
        def run():
            return kernel.selective_scan_fwd(*args)
        rec["ms"] = cuda_ms(run)
        rec["plain_ms"] = cuda_ms(lambda: ref.selective_scan_ref(*args),
                                  iters=5)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["profiler_ms"] = profiled_ms(run, "ss_fwd_kernel")
        rec["host_us_per_call"] = host_us(run)
    return rec


def ss_backward(Bt, L, di, N, dtype_name):
    """``backward_check`` of the selective-scan Functions at one shape:
    kernel forward and closed-form backward at f32 on the card, the
    closed-form path at f32 on the CPU, from the same inputs (x, B, C in
    the dtype) and the forward's tolerance."""
    import torch
    from repro_torch.kernels.mamba_scan import ops
    dt_ = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(L + di + 7)
    host = [torch.randn((Bt, L, di), generator=g).to(dt_),
            torch.empty((Bt, L, di)).uniform_(1e-3, 0.1, generator=g),
            -torch.empty((di, N)).uniform_(0.5, 2.0, generator=g),
            torch.randn((Bt, L, N), generator=g).to(dt_),
            torch.randn((Bt, L, N), generator=g).to(dt_),
            torch.randn((di,), generator=g),
            torch.randn((Bt, di, N), generator=g)]
    cot = [torch.randn((Bt, L, di), generator=g).to(dt_),
           torch.randn((Bt, di, N), generator=g)]
    return backward_check(lambda *a: ops.selective_scan(*a, chunk=512),
                          host, cot, TOL[dtype_name])


def phase_scan(serve_shape, train_shape, dt_rank):
    import torch
    recs = []
    for (Bt, L, di, N) in [(1, 64, 32, 8), (2, 128, 64, 16),
                           (2, 96, 48, 16),        # the reference's sweep
                           (1, 200, 8000, 16)]:    # ragged L tile and di block
        for dt in ("float32", "bfloat16"):
            rec = ss_case(Bt, L, di, N, dt)
            recs.append(rec)
            print("  selective_scan_fwd " + json.dumps(rec), flush=True)
    Bt, L, di, N = serve_shape
    slice_rec = ss_case(Bt, L, di, N, "bfloat16", proj_width=dt_rank + 2 * N,
                        timed=True)
    print("  selective_scan_fwd (serve shape) " + json.dumps(slice_rec),
          flush=True)
    long_rec = ss_case(Bt, LONG_PROMPT, di, N, "bfloat16",
                       proj_width=dt_rank + 2 * N, timed=True)
    print("  selective_scan_fwd (full prompt) " + json.dumps(long_rec),
          flush=True)
    Bt, L, di, N = train_shape
    train_rec = ss_case(Bt, L, di, N, "bfloat16",
                        proj_width=dt_rank + 2 * N, timed=True)
    train_rec.update(ss_backward(Bt, L, di, N, "bfloat16"))
    print("  selective_scan_fwd (train shape, with the Function's "
          "backward) " + json.dumps(train_rec), flush=True)
    bwd = [ss_backward(2, 128, 64, 16, dt) for dt in ("float32",
                                                      "bfloat16")]
    print("  selective_scan backward (sweep case, f32 and bf16) "
          + json.dumps(bwd), flush=True)
    torch.cuda.synchronize()
    every = recs + [slice_rec, long_rec, train_rec]
    bad = [r for r in every if not r["ok"]]
    check(not bad, f"selective_scan_fwd agrees with selective_scan_ref on "
          f"{len(every)} cases (y f32 2e-5, bf16 2e-2; h_last 2e-4)"
          + (f"; failing: {bad}" if bad else ""))
    bad = [r for r in [train_rec] + bwd if not r["bwd_ok"]]
    check(not bad, "the scan Function's backward on the card agrees with "
          "the CPU's (train shape bf16; a sweep case f32 and bf16)"
          + (f"; failing: {bad}" if bad else ""))
    return slice_rec, long_rec, train_rec


def phase_kernels(fa_shapes, ss_shapes, dt_rank):
    print("== phase 2: kernels against their plain versions on the card",
          flush=True)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = phase_flash(*fa_shapes)
    ss = phase_scan(*ss_shapes, dt_rank)
    return fa, ss


# ---------------------------------------------------------------------- serve
def serve_config(arch, batch=4, n_layers=None):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeProfile
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, RunConfig(model=cfg, shape=ShapeProfile("serve", 2048, batch,
                                                        "decode"),
                          remat="none")


def make_requests(cfg, n=8, max_new=32, seed=0):
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(0, cfg.vocab_size, int(
        rng.integers(384, 513))).astype(np.int32), max_new=max_new)
        for rid in range(n)]


def packed_len(run, reqs):
    """The first batch's packed prompt length (the server packs to the
    shortest prompt)."""
    return min(len(r.prompt) for r in reqs[:run.shape.global_batch])


def init_on_card(model, seed):
    """Random params drawn on the card and placed on the host (the local
    tier the Server expects): a 7 B model's f32 draws would not fit the
    host twice over, and the card draws them in well under a second."""
    import torch
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(
        seed), device="cpu")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return params, time.perf_counter() - t0


def kernel_counters():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.mamba_scan import kernel as ss
    return {"flash_attention_fwd": fa, "selective_scan_fwd": ss}


def reset_counters():
    """Every kernel's launch count and flash's counts by body to 0."""
    counters = kernel_counters()
    for mod in counters.values():
        mod.launches = 0
    fa_bodies = counters["flash_attention_fwd"].launches_by_body
    for body in fa_bodies:
        fa_bodies[body] = 0


def read_counters():
    """(launches by kernel, flash launches by body)."""
    counters = kernel_counters()
    return ({n: mod.launches for n, mod in counters.items()},
            dict(counters["flash_attention_fwd"].launches_by_body))


# --------------------------------------------- shapes the main paths launch
# The first main path that gave a kernel each shape key, and every key held
# against the plain version in this run (``fa_case``, ``ss_case``). Phase 13
# checks each launched key that the plan did not, and fails if one is left.
LAUNCHED = {"flash_attention_fwd": {}, "selective_scan_fwd": {}}
CHECKED = {"flash_attention_fwd": set(), "selective_scan_fwd": set()}
_PATH = [None]      # the main path being driven, None between paths
FA_SEEN = set()     # flash shape keys launched since the last clear


def fa_key(B, S, Skv, H, KV, dq, dv, dtype_name, causal, kv_len, body):
    return (B, S, Skv, H, KV, dq, dv, dtype_name, bool(causal),
            Skv if kv_len is None else int(kv_len), body)


def dtype_name_of(t):
    return str(t.dtype).removeprefix("torch.")


def watch_launch_shapes():
    """Wrap both kernels' public wrappers, the ones the models call, so
    that a call made while a main path is driven records its shape key
    under the path's name. The launch counts stay with the wrappers."""
    counters = kernel_counters()
    fa, ss = counters["flash_attention_fwd"], counters["selective_scan_fwd"]
    fa_fwd, ss_fwd = fa.flash_attention_fwd, ss.selective_scan_fwd

    def fa_watched(q, k, v, *, scale, causal=True, kv_len=None):
        if _PATH[0]:
            (B, S, H, dq), (_, Skv, KV, dv) = q.shape, v.shape
            key = fa_key(B, S, Skv, H, KV, dq, dv, dtype_name_of(q), causal,
                         kv_len, fa._body(q, k, v))
            LAUNCHED["flash_attention_fwd"].setdefault(key, _PATH[0])
            FA_SEEN.add(key)
        return fa_fwd(q, k, v, scale=scale, causal=causal, kv_len=kv_len)

    def ss_watched(x, dt, A, B, C, D, h0):
        if _PATH[0]:
            LAUNCHED["selective_scan_fwd"].setdefault(
                (*x.shape, A.shape[-1], dtype_name_of(x), B.stride(1)),
                _PATH[0])
        return ss_fwd(x, dt, A, B, C, D, h0)

    fa.flash_attention_fwd, ss.selective_scan_fwd = fa_watched, ss_watched


def on_path(path, fn, runtime=True):
    """``fn`` with ``path`` named as the main path it drives; a path
    through the Emerald runtime also runs under the sanitizer."""
    inner = sanitized(path, fn) if runtime else fn

    def drive(*args):
        _PATH[0] = path
        try:
            return inner(*args)
        finally:
            _PATH[0] = None
    return drive


# ------------------------------------------- the sanitizer over each path
SANITIZED = []      # one record per runtime path, in the order driven


def sanitized(path, fn):
    """``fn`` run inside ``sanitizer.record_submissions()``. When it
    returns, every run it submitted and each store it used are replayed
    through the happens-before sanitizer (H101-H103 on each run's event
    log, H110-H111 on each store's replica log) before the path's memory
    is freed; the counts are printed and a finding fails the run."""
    def drive(*args):
        from repro_torch.analysis import sanitizer
        with sanitizer.record_submissions() as rec:
            out = fn(*args)
        logged, total = rec.install_log()
        admission = {}
        for r in rec.runs:
            for rule in r.admission_rules:
                admission[rule] = admission.get(rule, 0) + 1
        entry = {"path": path, "submissions": len(rec.runs),
                 "still_running": rec.skipped, "events": rec.events,
                 "distinct_events": rec.distinct_events,
                 "stores": len(rec.stores), "installs_logged": logged,
                 "installs_total": total, "h111_judged": logged == total,
                 "findings": [str(f) for f in rec.findings],
                 "admission_rules": admission}
        SANITIZED.append(entry)
        print("  sanitizer " + json.dumps(entry), flush=True)
        if rec.findings:            # the event rows of the steps named
            steps = {s for f in rec.findings for s in f.steps}
            for i, r in enumerate(rec.runs):
                for e in r.events:
                    if e.step in steps:
                        print(f"  hazard row: run {i} ({r.state}) "
                              f"{e.kind} {e.step} {e.tier} t={e.t!r} "
                              f"{e.info}", flush=True)
        check(entry["submissions"] > 0,
              f"{path}: {entry['submissions']} runs replayed through the "
              f"sanitizer ({entry['events']} events)")
        check(not rec.findings,
              f"{path}: no happens-before hazard"
              + (f"; found: {entry['findings']}" if rec.findings else ""))
        return out
    return drive


def phase_sanitizer(expected):
    """Phase 14: the summary of every runtime path's replay; fails unless
    each path in ``expected`` was replayed, once, with no finding."""
    print("== phase 14: the sanitizer over every runtime path on the card",
          flush=True)
    for e in SANITIZED:
        judged = "judged" if e["h111_judged"] else "not judged (log trimmed)"
        print(f"  {e['path']}: {e['submissions']} runs, {e['events']} "
              f"events ({e['distinct_events']} distinct), installs "
              f"{e['installs_logged']} logged of {e['installs_total']}, "
              f"H111 {judged}, "
              f"{len(e['findings'])} findings, admission "
              f"{e['admission_rules'] or 'none'}", flush=True)
    seen = [e["path"] for e in SANITIZED]
    check(sorted(seen) == sorted(expected),
          f"the {len(expected)} runtime paths each replayed once"
          + (f"; replayed {seen}, expected {expected}"
             if sorted(seen) != sorted(expected) else ""))
    runs = sum(e["submissions"] for e in SANITIZED)
    check(not any(e["findings"] for e in SANITIZED),
          f"0 sanitizer findings over {runs} runs and "
          f"{sum(e['events'] for e in SANITIZED)} events")


def phase_launched_shapes():
    """Hold each kernel at every shape key a main path launched and the
    plan did not check, then require that no launched key is left
    unchecked. Returns the records of the keys checked here."""
    print("== phase 13: every shape the main paths launched, against the "
          "plain version", flush=True)
    import torch
    recs = []
    for key, path in LAUNCHED["flash_attention_fwd"].items():
        if key in CHECKED["flash_attention_fwd"]:
            continue
        B, S, Skv, H, KV, dq, dv, dt, causal, kv_len, body = key
        rec = fa_case(B=B, S=S, Skv=Skv, H=H, KV=KV, dq=dq, dv=dv,
                      dtype_name=dt, causal=causal, body=body,
                      kv_len=None if kv_len == Skv else kv_len)
        recs.append({"kernel": "flash_attention_fwd", "path": path, **rec})
    for key, path in LAUNCHED["selective_scan_fwd"].items():
        if key in CHECKED["selective_scan_fwd"]:
            continue
        Bt, L, di, N, dt, bc_stride = key
        rec = ss_case(Bt, L, di, N, dt, timed=True,
                      proj_width=None if bc_stride == N else bc_stride)
        recs.append({"kernel": "selective_scan_fwd", "path": path, **rec})
    torch.cuda.synchronize()
    for rec in recs:
        print("  unplanned " + json.dumps(rec), flush=True)
    bad = [r for r in recs if not r["ok"]]
    check(not bad, f"{len(recs)} launched shapes the plan did not hold "
          f"agree with the plain version (f32 2e-5, bf16 2e-2)"
          + (f"; failing: {bad}" if bad else ""))
    left = [(name, key, path) for name, keys in LAUNCHED.items()
            for key, path in keys.items() if key not in CHECKED[name]]
    n = sum(map(len, LAUNCHED.values()))
    check(n and not left,
          f"each of the {n} shape keys the main paths launched was held "
          f"against the plain version in this run"
          + (f"; left: {left}" if left else ""))
    return recs


def phase_serve(label, cfg, run, reqs, want, cut="full config"):
    """Serve ``reqs`` through the Server on the card; checks that every
    prefill launched each kernel ``want[name]`` times (0 where absent)
    and every decode none, all flash launches on the tma body."""
    print(f"== phase {label}: serve {cfg.name} ({cut}) through the "
          f"Emerald runtime on the card", flush=True)
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.launch.serve import Server
    from repro_torch.models.model_zoo import Model

    params, init_s = init_on_card(Model(run), seed=0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  params: {n_params} on the host ({cfg.param_dtype}), drawn on "
          f"the card in {init_s:.3f} s", flush=True)
    srv = Server(run, params)
    check(srv.tiers["cloud"].device.type == "cuda", "cloud tier on the card")
    prefill_s, decode_s, logits_seen, decode_up = [], [], [], []
    run_prefill, submit_decode = srv.ex_prefill.run, srv.ex_decode.submit

    def up_bytes():
        return srv.mdss.bytes_moved.get(("local", "cloud"), 0)

    def timed_prefill(*a, **k):
        t = time.perf_counter()
        out = run_prefill(*a, **k)
        prefill_s.append(time.perf_counter() - t)
        logits_seen.append(out["logits"])
        return out

    class _Timed:
        def __init__(self, handle, t, up):
            self.handle, self.t, self.up = handle, t, up

        def result(self, *a, **k):
            out = self.handle.result(*a, **k)
            decode_s.append(time.perf_counter() - self.t)
            decode_up.append(up_bytes() - self.up)
            logits_seen.append(out["logits"])
            return out

    def timed_submit(*a, **k):
        t, up = time.perf_counter(), up_bytes()
        return _Timed(submit_decode(*a, **k), t, up)

    srv.ex_prefill.run = timed_prefill
    srv.ex_decode.submit = timed_submit
    for r in reqs:
        srv.submit(r)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    try:
        done = []
        while srv.queue:
            done += srv.step_batch()
        serve_s = time.perf_counter() - t0
        launches, by_body = read_counters()
        peak = torch.cuda.max_memory_allocated()
        rep = srv.transfer_report()
        spans = srv.runtime.tracer.spans()
        cache = srv.mdss.peek_latest("cache")[0]
        cache_bytes = sum(x.nbytes for x in tree_leaves(cache))
    finally:
        srv.close()

    B = run.shape.global_batch
    n_new = reqs[0].max_new
    check(len(done) == len(reqs)
          and all(len(r.tokens) == n_new for r in done),
          f"{len(done)} requests got {n_new} tokens each")
    check(all(bool(torch.isfinite(l).all()) for l in logits_seen)
          and all(tuple(l.shape) == (B, cfg.vocab_padded)
                  for l in logits_seen),
          f"{len(logits_seen)} fetched logits are finite, ({B}, "
          f"{cfg.vocab_padded})")
    for name, n in launches.items():
        per = want.get(name, 0)
        total = per * srv.stats["prefills"]
        check(n == total, f"{name} launches {n} = {total}"
              + (f" ({per} per prefill x {srv.stats['prefills']} "
                 f"prefills)" if per else " (not on this path)"))
    want_tma = launches["flash_attention_fwd"]
    check(by_body == {"f32": 0, "mma": 0, "tma": want_tma},
          f"flash_attention_fwd launches by body {by_body}: every one on the "
          f"tma body")
    check(rep["decode_offloads"] == srv.stats["decode_calls"],
          f"every decode was an offload ({rep['decode_offloads']})")
    # code-only: a decode ships neither params nor cache, only the tokens
    # sampled from the last logits (MDSS counts them when they are new)
    tok_bytes = B * 4
    check(len(decode_up) == srv.stats["decode_calls"]
          and all(0 <= n <= tok_bytes for n in decode_up),
          f"every decode shipped only its tokens up (<= {tok_bytes} B "
          f"each; {sum(decode_up)} B in all)")
    fetched = len(logits_seen) * B * cfg.vocab_padded * 4
    back = rep["bytes_moved"].get(("cloud", "local"), 0)
    check(0 < back <= fetched,
          f"cloud->local bytes {back} are only the fetched logits "
          f"({fetched})")
    tot = {n: sum(s.dur_s for s in spans if s.name == n)
           for n in ("ship", "exec", "install")}
    by_step = {f"{n}_{st}_s": sum(s.dur_s for s in spans if s.name == n
                                  and s.attrs.get("step") == st)
               for n in ("ship", "exec", "install")
               for st in ("prefill", "decode")}
    out_tokens = sum(len(r.tokens) for r in done)
    stats = {
        "arch": cfg.name, "depth": cut, "n_layers": cfg.n_layers,
        "requests": len(done),
        "prompt_lens": [len(r.prompt) for r in reqs],
        "prefills": srv.stats["prefills"],
        "decode_calls": srv.stats["decode_calls"],
        "decode_code_only": rep["decode_code_only"],
        "prefill_s": prefill_s,
        "decode_ms_per_token": 1e3 * sum(decode_s) / max(len(decode_s), 1),
        "tokens_out": out_tokens, "serve_s": serve_s,
        "tokens_per_s": out_tokens / serve_s,
        "span_s": tot, **by_step,
        "bytes_moved": {f"{a}->{b}": n
                        for (a, b), n in rep["bytes_moved"].items()},
        "params_bytes": sum(x.nbytes for x in tree_leaves(params)),
        "cache_bytes": cache_bytes,
        "peak_device_bytes": peak, "launches": launches,
        "flash_launches_by_body": by_body,
    }
    print("  serve " + json.dumps(stats), flush=True)
    return launches


# ----------------------------------------------------------- model vs plain
def phase_model_parity(label, cfg):
    print(f"== phase {label}: {cfg.name} at 2 layers, full width, card "
          f"(bf16, kernel) vs CPU (f32, plain)", flush=True)
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs.base import RunConfig, ShapeProfile
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.params import torch_dtype
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                dtype="float32")
    cfg16 = dataclasses.replace(cfg32, param_dtype="bfloat16",
                                dtype="bfloat16")
    shape = ShapeProfile("parity", 256, 4, "decode")
    m32 = Model(RunConfig(model=cfg32, shape=shape, remat="none"))
    m16 = Model(RunConfig(model=cfg16, shape=shape, remat="none"))
    p32 = m32.init_params(torch.Generator().manual_seed(1))
    # one tree: the bf16 model's params are the f32 ones rounded, except
    # the leaves its template keeps in f32 (the SSM's A_log, dt_bias, D)
    p16 = tree_map(lambda t, s: t.to("cuda", torch_dtype(
        s.dtype or "bfloat16")), p32, m16.template)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                         dtype=torch.int32)
    l32, c32 = m32.prefill(p32, {"tokens": toks}, m32.init_cache("cpu"))
    l16, c16 = m16.prefill(p16, {"tokens": toks.cuda()},
                           m16.init_cache("cuda"))
    pairs = [(l32, l16.float().cpu())]
    tok = torch.argmax(l32, -1).to(torch.int32)
    for _ in range(4):   # teacher-forced with the CPU's greedy tokens
        l32, c32 = m32.decode_step(p32, tok, c32)
        l16, c16 = m16.decode_step(p16, tok.cuda(), c16)
        pairs.append((l32, l16.float().cpu()))
        tok = torch.argmax(l32, -1).to(torch.int32)
    a = torch.cat([p for p, _ in pairs])
    b = torch.cat([q for _, q in pairs])
    rel = float((b - a).norm() / a.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print("  parity " + json.dumps({"arch": cfg.name, "rel_err": rel,
                                    "rel_tol": LOGITS_REL_TOL,
                                    "argmax_agree": agree,
                                    "argmax_min": ARGMAX_AGREE_MIN,
                                    "rows": int(a.shape[0])}), flush=True)
    check(bool(torch.isfinite(b).all()), "card logits finite")
    check(rel <= LOGITS_REL_TOL,
          f"logits rel err {rel:.3e} <= {LOGITS_REL_TOL}")
    check(agree >= ARGMAX_AGREE_MIN,
          f"argmax agreement {agree:.3f} >= {ARGMAX_AGREE_MIN}")


# ------------------------------------------------- adjoint tomography
def emerald_manager(fabric=None):
    """A MigrationManager over the default tiers (cloud = the card), with
    ``fabric`` behind the cloud tier when given; returns it and the
    fabric's MDSS transport (None without one)."""
    from repro_torch.core import CostModel, MDSS, MigrationManager, \
        default_tiers
    tiers = default_tiers()
    cm = CostModel(tiers)
    mdss = MDSS(tiers, cost_model=cm)
    transport = None
    if fabric is not None:
        from repro_torch.cloud import attach
        transport = attach(tiers, fabric, mdss=mdss, cost_model=cm)
    return MigrationManager(tiers, mdss, cm), transport


def at_arm(cfg, obs, policy, fabric=None):
    """One warm-up and AT_ITERS timed AT iterations; model and obs are
    handed in once and stay MDSS-resident (the paper's saving)."""
    from repro_torch.apps import adjoint_tomography as at
    from repro_torch.core import EmeraldExecutor, partition
    mgr, transport = emerald_manager(fabric)
    mdss = mgr.mdss
    check(mgr.tiers["cloud"].device.type == "cuda", "cloud tier on the card")
    ex = EmeraldExecutor(partition(at.build_workflow(cfg)), mgr,
                         policy=policy)
    init = {"model": at.starting_model(cfg, "cpu"), "obs": obs}
    secs, chis, up, down = [], [], [], []
    for it in range(1 + AT_ITERS):
        if it == 1:
            n_rep, n_ev = len(mgr.reports), len(ex.events)
        before = dict(mdss.bytes_moved)
        t = time.perf_counter()
        res = ex.run(init)
        secs.append(time.perf_counter() - t)
        init = {}
        chis.append(res["chi"])
        moved = {k: v - before.get(k, 0) for k, v in mdss.bytes_moved.items()}
        up.append(moved.get(("local", "cloud"), 0))
        down.append(moved.get(("cloud", "local"), 0))
    exec_s = {}
    for rep in mgr.reports[n_rep:]:
        key = f"{rep.step}@{rep.tier}"
        exec_s[key] = exec_s.get(key, 0.0) + rep.seconds / AT_ITERS
    offloads = sum(1 for e in ex.events[n_ev:]
                   if e.kind == "offload" and e.tier == "cloud")
    obs_ships = [e for e in mdss.sync_events if e[0] == "obs"]
    rec = {"mesh": cfg.mesh_name, "nt": cfg.nt, "policy": policy,
           "fabric": fabric is not None,
           "s_per_iter": sum(secs[1:]) / AT_ITERS, "warmup_s": secs[0],
           "iter_s": secs[1:], "exec_s_per_iter": exec_s,
           "offloads": offloads, "chi": [float(c) for c in chis],
           "bytes_up_per_iter": up, "bytes_down_per_iter": down,
           "bytes_moved": {f"{a}->{b}": n
                           for (a, b), n in mdss.bytes_moved.items()},
           "obs_ships": len(obs_ships)}
    return rec, chis, res["model"], mdss, transport


def at_kernel_profile(cfg, obs):
    """One Fréchet-kernel step (forward, recompute and backward through
    nt leapfrog steps) on the card at the starting model: wall time, the
    device time of every kernel it launches (torch.profiler), the launch
    count, and the card's idle share of the profiled call's wall time
    (device and wall time of the same call; the unprofiled wall time
    beside it shows what the profiler adds on the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps import adjoint_tomography as at
    fn = at.step_kernel(cfg)
    model, obs = at.starting_model(cfg, "cuda"), obs.to("cuda")
    fn(model, obs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn(model, obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn(model, obs)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    dev_s = sum(getattr(e, "device_time_total", 0.0) for e in dev) / 1e6
    launches = sum(e.count for e in dev)
    return {"wall_s": wall, "profiled_wall_s": prof_wall, "device_s": dev_s,
            "device_launches": launches,
            "launches_per_timestep": launches / cfg.nt,
            "idle_share": 1 - dev_s / prof_wall if dev_s else None}


def max_rel(a, b):
    import torch
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(((a - b).abs() / b.abs()).max())


def phase_at(cfg):
    """Local against offloaded at one mesh; returns the offloaded arm."""
    import torch
    from repro_torch.apps import adjoint_tomography as at
    print(f"== phase 5: adjoint tomography {cfg.mesh_name}, nt={cfg.nt}: "
          f"local (host CPU) vs offloaded (steps 2-4 on the card)",
          flush=True)
    t = time.perf_counter()
    obs = at.make_observations(cfg, "cuda").cpu()
    print(f"  observations {tuple(obs.shape)} in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    reset_counters()
    local, lchis, lmodel, _, _ = sanitized(
        f"adjoint tomography {cfg.mesh_name} local", at_arm)(
        cfg, obs, "never")
    off, ochis, omodel, omdss, _ = sanitized(
        f"adjoint tomography {cfg.mesh_name} offloaded", at_arm)(
        cfg, obs, "annotate")
    launches, _ = read_counters()
    profile = at_kernel_profile(cfg, obs)
    rec = {"mesh": cfg.mesh_name, "local": local, "offloaded": off,
           "kernel_step_on_card": profile,
           "host_cpus": len(os.sched_getaffinity(0)),
           "torch_threads": torch.get_num_threads(),
           "reduction": 1 - off["s_per_iter"] / local["s_per_iter"],
           "chi_max_rel_diff": max_rel(torch.stack(ochis),
                                       torch.stack(lchis)),
           "model_max_rel_diff": max_rel(omodel.cpu(), lmodel.cpu()),
           "launches": launches}
    print("  at " + json.dumps(rec), flush=True)
    check(all(bool(torch.isfinite(torch.as_tensor(c))) for c in lchis + ochis)
          and bool(torch.isfinite(omodel).all())
          and tuple(omodel.shape) == (cfg.nx, cfg.ny, cfg.nz),
          f"chi and the final model finite, model {tuple(omodel.shape)}")
    check(lchis[-1] < lchis[0], f"misfit decreases: {local['chi']}")
    check(rec["chi_max_rel_diff"] <= AT_RTOL
          and rec["model_max_rel_diff"] <= AT_RTOL,
          f"offloaded equals local: chi {rec['chi_max_rel_diff']:.3e}, "
          f"model {rec['model_max_rel_diff']:.3e} (rtol {AT_RTOL})")
    # every op of a step rounds alike on the host and the card (see
    # adjoint_tomography._laplacian): only chi's final sum may differ
    check(torch.equal(omodel.cpu(), lmodel.cpu()),
          "final models of the two arms equal bitwise")
    check(off["offloads"] == 3 * AT_ITERS and local["offloads"] == 0,
          f"{off['offloads']} offloads in {AT_ITERS} iterations (steps 2-4)")
    check(off["obs_ships"] == 1
          and len(set(off["bytes_up_per_iter"][1:])) == 1
          and off["bytes_up_per_iter"][1] < off["bytes_up_per_iter"][0],
          f"obs shipped once; up bytes per iteration "
          f"{off['bytes_up_per_iter']}")
    check(not any(launches.values()),
          f"no kernel launched on this path: {launches}")
    print(f"  measured reduction {rec['reduction']:.4f} of the local time "
          f"per iteration (the paper claims up to 0.55)", flush=True)
    return {"obs": obs, "chis": ochis, "model": omodel, "mdss": omdss}


def worker_processes():
    """pids of live fabric workers of this port on this machine."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if b"repro_torch.cloud.worker" in cmd:
            pids.append(int(d))
    return pids


def phase_at_fabric(cfg, offloaded):
    print(f"== phase 6: adjoint tomography {cfg.mesh_name} offloaded, with "
          f"a fabric behind the card", flush=True)
    import numpy as np
    import torch
    from repro_torch.cloud import Fabric
    from repro_torch.core import EmeraldExecutor, Workflow, partition
    obs = offloaded["obs"]
    reset_counters()
    with Fabric(workers=2) as fabric:
        pids = fabric.broker.worker_pids()
        rec, chis, model, mdss, transport = at_arm(cfg, obs, "annotate",
                                                   fabric)
        launches, _ = read_counters()
        # a registry step through the same manager: it runs in a worker
        mgr, _ = emerald_manager(fabric)
        wf = Workflow("registry-step")
        wf.var("x")
        wf.step("pid", None, inputs=("x",), outputs=("pid",),
                remotable=True, device_step=False, remote_impl="pid")
        ex = EmeraldExecutor(partition(wf), mgr)
        out = ex.run({"x": np.float64(0.0)})
        (off,) = [e for e in ex.events if e.kind == "offload"]
    left = [p for p in worker_processes() if p in pids]
    rec.update(shipped_bytes=transport.total_bytes_shipped(),
               ship_events=len(transport.ship_events),
               metadata_only_ships=transport.metadata_only_ships,
               worker_pids=pids, registry_step_pid=int(out["pid"]),
               launches=launches)
    print("  at_fabric " + json.dumps(rec), flush=True)
    check(all(torch.equal(a.cpu(), b.cpu())
              for a, b in zip(chis, offloaded["chis"]))
          and torch.equal(model.cpu(), offloaded["model"].cpu()),
          "chi and the final model equal phase 5's offloaded arm bitwise")
    check(rec["offloads"] == 3 * AT_ITERS,
          f"{rec['offloads']} offloads, all in-process on the card")
    check(dict(mdss.bytes_moved) == dict(offloaded["mdss"].bytes_moved),
          f"MDSS accounts phase 5's bytes: {rec['bytes_moved']}")
    check(rec["shipped_bytes"] > 0,
          f"{rec['shipped_bytes']} wire bytes crossed worker processes")
    check(off.info["remote"] and int(out["pid"]) in pids
          and int(out["pid"]) != os.getpid(),
          f"registry step ran in worker {int(out['pid'])} (driver "
          f"{os.getpid()})")
    check(not left, f"no worker process left after the fabric exits "
          f"(workers were {pids})")
    check(not any(launches.values()),
          f"no kernel launched on this path: {launches}")


def phase_tenants(cfg, fig11):
    """Phase 15: the explorer's dispatch seam driving the real runtime on
    the card. Three tenants each submit one AT iteration (phase 5's
    observations and starting model, policy "annotate") to one runtime
    with ``max_workers=2`` under a ``dispatch_hook``: last-submitted-first,
    then a seeded pick. Each tenant's misfit and updated model must equal
    a solo run's bitwise, and every run replays clean (``sanitized``).
    Returns the names of the paths it drove."""
    print(f"== phase 15: three tenants' adjoint tomography {cfg.mesh_name} "
          f"through dispatch hooks on the card", flush=True)
    import random
    from concurrent.futures import ThreadPoolExecutor as Pool
    import torch
    from repro_torch.apps import adjoint_tomography as at
    from repro_torch.core import EmeraldRuntime, partition
    from repro_torch.tools.emtop import render
    wf = partition(at.build_workflow(cfg))

    def inputs():
        return {"model": at.starting_model(cfg, "cpu"), "obs": fig11["obs"]}

    def solo_run():
        mgr, _ = emerald_manager()
        check(mgr.tiers["cloud"].device.type == "cuda",
              "cloud tier on the card")
        with EmeraldRuntime(mgr, max_workers=2, policy="annotate") as rt:
            t = time.perf_counter()
            out = rt.submit(wf, inputs()).result(300)
            return out, time.perf_counter() - t

    solo, solo_s = sanitized(f"adjoint tomography {cfg.mesh_name} solo",
                             solo_run)()
    print(f"  solo iteration: chi {float(solo['chi'])!r} in {solo_s:.3f} s; "
          f"chi equals phase 5's first offloaded iteration bitwise: "
          f"{torch.equal(solo['chi'].cpu(), fig11['chis'][0].cpu())}",
          flush=True)

    def tenants(pick):
        calls = []

        def hook(lane, run_ids):
            chosen = pick(run_ids)
            calls.append(chosen)
            return chosen

        mgr, _ = emerald_manager()
        with EmeraldRuntime(mgr, max_workers=2, policy="annotate",
                            dispatch_hook=hook) as rt, Pool(3) as pool:
            futs, handles = [], []
            for _ in range(3):
                t = time.perf_counter()
                h = rt.submit(wf, inputs())
                handles.append(h)
                futs.append(pool.submit(
                    lambda h=h, t=t: (h.result(300),
                                      time.perf_counter() - t)))
            snap = rt.introspect()
            outs = [f.result() for f in futs]
            moved = {f"{a}->{b}": n for (a, b), n in
                     rt.mdss.bytes_moved.items()}
        per = []
        for h, (out, wall) in zip(handles, outs):
            offl = [e for e in h.events if e.kind == "offload"]
            per.append({
                "run": h.run_id, "hook_calls": calls.count(h.run_id),
                "offloads": len(offl),
                "bytes_up": sum(e.info.get("bytes_in", 0) for e in offl),
                "bytes_down": sum(e.info.get("bytes_out", 0) for e in offl),
                "wall_s": wall,
                "chi_equal": torch.equal(out["chi"].cpu(),
                                         solo["chi"].cpu()),
                "model_equal": torch.equal(out["model"].cpu(),
                                           solo["model"].cpu())})
        return per, len(calls), moved, snap

    rng = random.Random(TENANT_SEED)
    hooks = {"last-submitted-first": lambda ids: ids[-1],
             f"seeded pick (random.Random({TENANT_SEED}))": rng.choice}
    paths = [f"adjoint tomography {cfg.mesh_name} solo"]
    for name, pick in hooks.items():
        paths.append(f"adjoint tomography {cfg.mesh_name} x3 tenants, {name}")
        per, n_calls, moved, snap = sanitized(paths[-1], tenants)(pick)
        print(f"  hook {name}: {n_calls} calls; MDSS bytes {moved}",
              flush=True)
        for rec in per:
            print("  tenant " + json.dumps(rec), flush=True)
        check(n_calls > 0 and sum(r["hook_calls"] for r in per) == n_calls,
              f"{name}: the hook chose each of its {n_calls} dispatches")
        check(all(r["offloads"] == 3 for r in per),
              f"{name}: 3 offloads (steps 2-4) per tenant")
        check(all(r["chi_equal"] and r["model_equal"] for r in per),
              f"{name}: each tenant's chi and updated model equal the solo "
              f"run's bitwise")
    lines = render(snap).splitlines()
    for line in lines[:16]:
        print(f"  emtop| {line}", flush=True)
    check(lines[0].startswith("emerald runtime") and "RUNS" in lines,
          "emtop renders the runtime's live snapshot")
    return paths


def phase_frontdoor(cfg, run):
    print(f"== phase 7: FrontDoor in front of {cfg.name} (full config) on "
          f"the card", flush=True)
    import threading
    import numpy as np
    import torch
    from repro_torch._tree import to_device
    from repro_torch.launch.serve import FrontDoor
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import Model
    from repro_torch.core import EmeraldRuntime
    model = Model(run)
    params, _ = init_on_card(model, seed=0)
    dev_params = to_device(params, "cuda")
    del params
    prefill = model.prefill

    def decode_window(tokens):
        """Logits of each row's last position after the full forward
        over its window: row-independent and stateless."""
        toks = torch.from_numpy(np.ascontiguousarray(tokens)).to("cuda")
        cache = tfm.init_cache(cfg, toks.shape[0], toks.shape[1], "cuda")
        logits, _ = prefill(dev_params, {"tokens": toks}, cache)
        return logits.float().cpu().numpy()

    rng = np.random.default_rng(7)
    windows = [rng.integers(0, cfg.vocab_size, FD_WINDOW).astype(np.int32)
               for _ in range(FD_REQUESTS)]
    decode_window(np.stack(windows[:2]))        # warm the card
    mgr, _ = emerald_manager()
    rows, lat = [None] * FD_REQUESTS, [None] * FD_REQUESTS
    with EmeraldRuntime(mgr, max_workers=4) as rt:
        fd = FrontDoor(rt, decode_window, window_s=0.004, max_batch=32)

        def client(c):
            for i in range(c, FD_REQUESTS, FD_CLIENTS):
                t = time.perf_counter()
                rows[i] = fd.decode(windows[i]).result(120)
                lat[i] = time.perf_counter() - t

        reset_counters()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(FD_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        launches, _ = read_counters()
        stats = fd.stats()
        fd.close()
    check(not any(t.is_alive() for t in threads)
          and all(r is not None for r in rows),
          f"{FD_REQUESTS} requests from {FD_CLIENTS} clients answered")
    flushes = stats["flushes"]
    alone = [decode_window(w[None])[0] for w in windows]
    got, want = np.stack(rows), np.stack(alone)
    rel = [float(np.linalg.norm(g - w) / np.linalg.norm(w))
           for g, w in zip(got, want)]
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    lat_ms = np.array(lat) * 1e3
    rec = {"arch": cfg.name, "requests": FD_REQUESTS, "clients": FD_CLIENTS,
           "window_tokens": FD_WINDOW, "flushes": flushes,
           "rows_per_flush": FD_REQUESTS / max(flushes, 1),
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)), "wall_s": wall,
           "requests_per_s": FD_REQUESTS / wall, "launches": launches,
           "flash_launches_per_flush":
               launches["flash_attention_fwd"] / max(flushes, 1),
           "max_row_rel_err": max(rel), "rel_tol": FD_REL_TOL,
           "argmax_agree": agree, "argmax_min": ARGMAX_AGREE_MIN}
    print("  frontdoor " + json.dumps(rec), flush=True)
    check(bool(np.isfinite(got).all())
          and got.shape == (FD_REQUESTS, cfg.vocab_padded),
          f"rows finite, ({FD_REQUESTS}, {cfg.vocab_padded})")
    check(flushes >= 2 and launches["flash_attention_fwd"]
          == cfg.n_layers * flushes and launches["selective_scan_fwd"] == 0,
          f"flash_attention_fwd launches {launches['flash_attention_fwd']} "
          f"= {cfg.n_layers} layers x {flushes} flushes; no scan")
    check(max(rel) <= FD_REL_TOL,
          f"every row against its window alone: rel err {max(rel):.3e} <= "
          f"{FD_REL_TOL}")
    check(agree >= ARGMAX_AGREE_MIN,
          f"argmax agreement {agree:.3f} >= {ARGMAX_AGREE_MIN}")
    return launches


# ---------------------------------------------------------------------- train
def train_run(arch, seq, batch, n_layers=None, grad_accum=1, small=False):
    """The train RunConfig; ``small``: the arch's reduced (CPU test)
    config, f32."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
    cfg = reduced(get_config(arch)) if small else get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, RunConfig(model=cfg, shape=ShapeProfile("train", seq, batch,
                                                        "train"),
                          remat="full", grad_accum=grad_accum,
                          optimizer="adamw", opt_state_dtype="float32")


def device_seconds(prof):
    """(kernel s, copy s) summed over the device events of a profile."""
    from torch.autograd import DeviceType
    kern = copy = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", 0.0)
        if e.key.startswith(("Memcpy", "Memset")):
            copy += us / 1e6
        else:
            kern += us / 1e6
    return kern, copy


def phase_train(label, cfg, run, per_step, n_steps=TRAIN_STEPS, cut=""):
    """Train ``run`` through the port's Trainer on the card for
    ``n_steps`` steps (a warm-up, then timed steps, the last under
    torch.profiler); checks each kernel's launches per step
    (``per_step[name]``, 0 where absent, flash on the tma body for bf16
    and the f32 body for float32), the offloads and the bytes each step
    ships up. Returns the launches of the whole run."""
    print(f"== phase {label}: train {cfg.name} ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}{', ' + cut if cut else ''}) through the "
          f"Trainer on the card", flush=True)
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch._tree import tree_leaves
    from repro_torch.launch.train import Trainer
    counters = kernel_counters()
    tr = Trainer(run, policy="annotate")
    check(tr.tiers["cloud"].device.type == "cuda", "cloud tier on the card")
    sp = run.shape
    batch_bytes = sum(v.nbytes for v in tr.data.batch(0).values())
    steps = []
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    try:
        for i in range(n_steps):
            n_spans = len(tr.runtime.tracer.spans())
            up0 = tr.mdss.bytes_moved.get(("local", "cloud"), 0)
            l0 = {n: mod.launches for n, mod in counters.items()}
            profiled = i == n_steps - 1
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                    if profiled else contextlib.nullcontext())
            with prof:
                t0 = time.perf_counter()
                tr.fit(1, log_every=0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            spans = [x for x in tr.runtime.tracer.spans()[n_spans:]
                     if x.attrs.get("step") == "train_step"]
            rec = {"step": i, "wall_s": wall, "profiled": profiled,
                   "up_bytes": tr.mdss.bytes_moved.get(("local", "cloud"), 0)
                   - up0,
                   "launches": {n: mod.launches - l0[n]
                                for n, mod in counters.items()},
                   **{f"{n}_s": sum(x.dur_s for x in spans if x.name == n)
                      for n in ("ship", "exec", "install")},
                   "loss": tr.history[-1]["loss"],
                   "grad_norm": tr.history[-1]["grad_norm"]}
            if profiled:
                kern, copy = device_seconds(prof)
                rec.update(device_kernel_s=kern, device_copy_s=copy,
                           idle_share=1 - (kern + copy) / wall,
                           compute_idle_share=1 - kern / wall)
            steps.append(rec)
            print(f"  step {json.dumps(rec)}", flush=True)
        peak = torch.cuda.max_memory_allocated()
        launches, by_body = read_counters()
        rep = tr.transfer_report()
        state_bytes = sum(x.nbytes for x in tree_leaves(
            (tr.mdss.peek_latest("params")[0],
             tr.mdss.peek_latest("opt_state")[0])))
        ships = [(u, a, b) for u, a, b, _ in tr.mdss.sync_events
                 if u in ("params", "opt_state")]
    finally:
        tr.close()
    timed_s = steps[1]["wall_s"]
    tokens = sp.global_batch * sp.seq_len
    stats = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "depth": cut or "full config", "steps": n_steps,
        "seq": sp.seq_len, "batch": sp.global_batch,
        "grad_accum": run.grad_accum, "remat": run.remat,
        "s_per_step": timed_s, "tokens_per_s": tokens / timed_s,
        "profiled_step_s": steps[-1]["wall_s"],
        "profiler_cost_s": steps[-1]["wall_s"] - timed_s,
        "idle_share": steps[-1]["idle_share"],
        "compute_idle_share": steps[-1]["compute_idle_share"],
        "peak_device_bytes": peak, "params_and_opt_state_bytes": state_bytes,
        "batch_bytes": batch_bytes, "state_ships": ships,
        "offloads": rep["offloads"],
        "code_only": rep["code_only"],
        "bytes_moved": {f"{a}->{b}": n
                        for (a, b), n in rep["bytes_moved"].items()},
        "launches": launches, "flash_launches_by_body": by_body}
    print("  train " + json.dumps(stats), flush=True)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in steps),
          f"loss and grad_norm finite: {[r['loss'] for r in steps]}, "
          f"{[r['grad_norm'] for r in steps]}")
    for name in counters:
        want = per_step.get(name, 0)
        check(all(r["launches"][name] == want for r in steps),
              f"{name} launches {[r['launches'][name] for r in steps]} = "
              f"{want} per step")
    body = "f32" if cfg.dtype == "float32" else "tma"
    n_fa = launches["flash_attention_fwd"]
    check(by_body == {b: n_fa if b == body else 0 for b in by_body},
          f"flash_attention_fwd launches by body {by_body}: every one on "
          f"the {body} body")
    check(rep["offloads"] == n_steps,
          f"{rep['offloads']} offloads of train_step")
    check(sorted(ships) == [("opt_state", "local", "cloud"),
                            ("params", "local", "cloud")],
          f"params and optimizer state shipped to the card once, in the "
          f"first step ({steps[0]['up_bytes']} B up; {state_bytes} B of "
          f"state, less what MDSS's chunk dedup found identical): {ships}")
    check(all(batch_bytes <= r["up_bytes"] <= batch_bytes + FRAMING_MAX
              for r in steps[1:]),
          f"later steps shipped only the batch ({batch_bytes} B, + <= "
          f"{FRAMING_MAX} B): {[r['up_bytes'] for r in steps[1:]]}")
    return launches


def train_step_parity(cfg, run, params, batch):
    """One train step of ``run`` from the host ``params`` and ``batch`` on
    the card (f32 kernel bodies) against the CPU (plain versions): loss,
    xent, aux and mtp within STEP_LOSS_RTOL, grad_norm within
    STEP_GNORM_RTOL, every updated leaf within 2 lr_1, and the card's
    launches those of one step (``train_launches``), flash on the f32
    body. Returns the record."""
    import torch
    from repro_torch._tree import to_device, tree_leaves
    from repro_torch.models.model_zoo import Model
    model = Model(run)
    opt = model.opt_init(params)
    reset_counters()
    t = time.perf_counter()
    pc, _, mc = model.train_step(to_device(params, "cuda"),
                                 to_device(opt, "cuda"),
                                 to_device(batch, "cuda"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    launches, by_body = read_counters()
    t = time.perf_counter()
    ph, _, mh = model.train_step(params, opt, batch)
    cpu_s = time.perf_counter() - t
    lr1 = float(mh["lr"])
    leaf_err = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(tree_leaves(pc), tree_leaves(ph)))
    rel = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
           for k in ("loss", "xent", "aux", "mtp", "grad_norm")
           if k in mh and float(mh[k]) != 0}
    rec = {"arch": cfg.name, "card": {k: float(v) for k, v in mc.items()},
           "cpu": {k: float(v) for k, v in mh.items()}, "rel_diff": rel,
           "max_leaf_abs_diff": leaf_err, "two_lr1": 2 * lr1,
           "card_s": card_s, "cpu_s": cpu_s, "launches": launches,
           "flash_launches_by_body": by_body}
    print("  train_parity " + json.dumps(rec), flush=True)
    losses = {k: v for k, v in rel.items() if k != "grad_norm"}
    check(max(losses.values()) <= STEP_LOSS_RTOL,
          f"loss rel diffs {losses} <= {STEP_LOSS_RTOL}")
    check(rel["grad_norm"] <= STEP_GNORM_RTOL,
          f"grad_norm rel diff {rel['grad_norm']:.3e} <= {STEP_GNORM_RTOL}")
    check(leaf_err <= 2 * lr1,
          f"every updated leaf within 2 lr_1: {leaf_err:.3e} <= "
          f"{2 * lr1:.3e}")
    want = train_launches(cfg, run.grad_accum)
    check(launches == want and by_body["f32"]
          == want["flash_attention_fwd"],
          f"the card's step launched {launches} = {want} (forward and "
          f"recompute), flash on the f32 body")
    return rec


def phase_train_parity(label, arch):
    """One f32 train step at 2 layers, full width, card vs CPU."""
    print(f"== phase {label}: one train step of {arch} at 2 layers, full "
          f"width, f32: card (kernels) vs CPU (plain)", flush=True)
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import Model
    cfg, run = train_run(arch, 128, 2, n_layers=2)
    cfg = dataclasses.replace(cfg, param_dtype="float32", dtype="float32")
    run = run.with_(model=cfg)
    params, _ = init_on_card(Model(run), seed=3)
    batch = SyntheticLMData(cfg, run.shape, seed=3).batch(0)
    train_step_parity(cfg, run, params, batch)


# ------------------------------------------------------------- the model zoo
# The six architectures beyond the dense and Mamba-only ones, with the
# depth each runs at on one 80 GB card (bf16 params; train with AdamW f32
# state at ~28 B per param, PERF.md): serve depth, train depth, tokens.
ZOO_SERVE = (("internvl2-1b", None), ("qwen2-moe-a2.7b", 8),
             ("minicpm3-4b", None), ("jamba-v0.1-52b", 8),
             ("deepseek-v3-671b", 4))
ZOO_TRAIN = (("internvl2-1b", None, 2048), ("seamless-m4t-medium", None, 1024),
             ("minicpm3-4b", 8, 1024), ("qwen2-moe-a2.7b", 2, 1024))
ZOO_CUT = {
    ("jamba-v0.1-52b", "serve"): "8 of 32 layers (one attention period: "
    "7 Mamba layers, 4 of them MoE, and the attention layer; 13.3 B params)",
    ("deepseek-v3-671b", "serve"): "4 of 61 layers (the 3 dense layers and "
    "one 256-expert MoE layer; 15.8 B params)",
    ("qwen2-moe-a2.7b", "serve"): "8 of 24 layers (24 until phase 17 "
    "needed the script's time; 9.7 B params)",
    ("minicpm3-4b", "train"): "8 of 62 layers (the whole 4.4 B model with "
    "AdamW f32 state needs ~123 GB; 16 until phase 17 needed the time)",
    ("qwen2-moe-a2.7b", "train"): "2 of 24 layers (the whole 14.3 B model "
    "with AdamW f32 state needs ~400 GB)",
    ("jamba-v0.1-52b", "train"): "reduced config (one mamba_moe layer at "
    "full width is 2.8 B params: with its gradient and AdamW f32 state it "
    "does not fit one card; waits on sharding)",
    ("deepseek-v3-671b", "train"): "reduced config (one 256-expert MoE "
    "layer at full width is 11.3 B params: with its gradient and AdamW f32 "
    "state it does not fit one card; waits on sharding)",
}
ZOO_SERVE_NEW = 8        # tokens per request on the zoo's serve paths
ZOO_PARITY_TOL = 1e-4    # f32 logits card vs CPU (the CPU tests' serve bound)


def zoo_launches(cfg):
    """Kernel launches of one forward over a sequence: flash attention
    once per attention layer (and per encoder layer and cross-attention
    of an encoder-decoder), the selective scan once per Mamba layer."""
    from repro_torch.configs.base import ATTN_DENSE, ATTN_MOE
    n_attn = sum(cfg.block_type(i) in (ATTN_DENSE, ATTN_MOE)
                 for i in range(cfg.n_layers))
    fa = n_attn + (cfg.n_encoder_layers + cfg.n_layers
                   if cfg.is_encoder_decoder else 0)
    return {"flash_attention_fwd": fa,
            "selective_scan_fwd": cfg.n_layers - n_attn}


def train_launches(cfg, grad_accum=1):
    """Launches of one train step under remat "full": every block's
    forward runs again in the backward; the MTP head's block is not
    rematerialised."""
    per = zoo_launches(cfg)
    return {"flash_attention_fwd": grad_accum * (
                2 * per["flash_attention_fwd"] + int(cfg.mtp)),
            "selective_scan_fwd": grad_accum * 2 * per["selective_scan_fwd"]}


def phase_kernels_zoo(fa_cases, ss_cases):
    """Flash attention at every call of the zoo's serve and train paths
    (MLA's dq != dv, up to 192; non-causal encoders and cross-attention
    with Sq != Skv; the reduced f32 train configs) on the body the wrapper
    picks, and MLA's and cross-attention's serve shapes on the mma.sync
    and f32 bodies too; the scan at each hybrid path's shape."""
    print("== phase 2b: kernels at the model zoo's shapes on the card",
          flush=True)
    import torch
    recs = {}
    for name, c, other_bodies in fa_cases:
        rec = fa_case(**c, profiled=True)
        rec["path"] = name
        recs[name] = rec
        print(f"  flash_attention_fwd ({name}) " + json.dumps(rec),
              flush=True)
        for body in other_bodies:
            dt = "float32" if body == "f32" else "bfloat16"
            r = fa_case(**dict(c, dtype_name=dt), body=body)
            rec[f"{body}_body"] = {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "max_abs_err", "tol", "ok")}
            print(f"  flash_attention_fwd ({name}, {body} body) "
                  + json.dumps(r), flush=True)
    ss_recs = {}
    for name, (Bt, L, di, N, r, dt) in ss_cases:
        rec = ss_case(Bt, L, di, N, dt, proj_width=r + 2 * N, timed=True)
        rec["path"] = name
        ss_recs[name] = rec
        print(f"  selective_scan_fwd ({name}) " + json.dumps(rec), flush=True)
    torch.cuda.synchronize()
    every = list(recs.values()) + [r[f"{b}_body"] for r in recs.values()
                                   for b in ("mma", "f32")
                                   if f"{b}_body" in r]
    bad = [r for r in every + list(ss_recs.values()) if not r["ok"]]
    check(not bad, f"{len(every)} flash cases at the zoo's shapes agree with "
          f"attention_ref (f32 2e-5, bf16 2e-2) and {len(ss_recs)} scan "
          f"cases with selective_scan_ref"
          + (f"; failing: {bad}" if bad else ""))
    check(all(r["body"] == ("f32" if r["dtype"] == "float32" else "tma")
              for r in recs.values()),
          "every bf16 zoo shape ran the tma body, every f32 one the f32 "
          "body")
    return recs, ss_recs


def phase_serve_encdec(label, cfg, run, prompt, n_new):
    """seamless-m4t-medium through ``Model.prefill``/``decode_step`` on the
    card: the JAX package's Server feeds prefill tokens only, and the
    encoder reads ``encoder_embeds`` (PERF.md), so an encoder-decoder is
    served the way its reference's arch smoke test drives it."""
    print(f"== phase {label}: serve {cfg.name} (full config) through "
          f"Model.prefill / decode_step on the card", flush=True)
    import torch
    from repro_torch._tree import to_device, tree_leaves
    from repro_torch.configs.base import ShapeProfile
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import Model
    model = Model(run)
    params, init_s = init_on_card(model, seed=0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    dev = to_device(params, "cuda")
    del params
    B, S = run.shape.global_batch, run.shape.seq_len
    batch = SyntheticLMData(cfg, ShapeProfile("serve", S, B, "train")
                            ).batch(0)
    batch = {"encoder_embeds": batch["encoder_embeds"].cuda(),
             "tokens": batch["tokens"][:, :prompt].cuda()}
    cache = model.init_cache("cuda")
    model.prefill(dev, batch, cache)          # warm the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t = time.perf_counter()
    logits, cache = model.prefill(dev, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    after_prefill, by_body = read_counters()
    seen, decode_s = [logits], []
    for _ in range(n_new - 1):
        tok = torch.argmax(logits, -1).to(torch.int32)
        t = time.perf_counter()
        logits, cache = model.decode_step(dev, tok, cache)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t)
        seen.append(logits)
    launches, _ = read_counters()
    peak = torch.cuda.max_memory_allocated()
    want = zoo_launches(cfg)
    stats = {"arch": cfg.name, "depth": "full config",
             "encoder_layers": cfg.n_encoder_layers,
             "decoder_layers": cfg.n_layers, "params": n_params,
             "batch": B, "encoder_frames": S, "prompt_tokens": prompt,
             "prefill_s": prefill_s,
             "decode_ms_per_token": 1e3 * sum(decode_s) / len(decode_s),
             "peak_device_bytes": peak, "launches": launches,
             "flash_launches_by_body": by_body,
             "cache_pos": tfm.cache_position(cache)}
    print("  serve " + json.dumps(stats), flush=True)
    check(all(bool(torch.isfinite(l).all())
              and tuple(l.shape) == (B, cfg.vocab_padded) for l in seen),
          f"{len(seen)} logits finite, ({B}, {cfg.vocab_padded})")
    check(after_prefill == launches == want,
          f"the prefill launched {after_prefill} (encoder "
          f"{cfg.n_encoder_layers} + decoder self {cfg.n_layers} + cross "
          f"{cfg.n_layers} flash), the {n_new - 1} decodes none")
    check(by_body["tma"] == want["flash_attention_fwd"],
          f"flash launches by body {by_body}: every one on the tma body")
    check(stats["cache_pos"] == prompt + n_new - 1,
          f"cache position {stats['cache_pos']} = {prompt} + {n_new - 1}")
    return launches


def phase_zoo_parity(label, arch):
    """One architecture at its reduced (CPU test) config, f32, from one
    param tree: prefill and two decode steps' logits, and one train step,
    on the card (f32 kernel bodies) against the CPU (plain versions)."""
    print(f"== phase {label}: {arch} reduced, f32: card (kernels) vs CPU "
          f"(plain)", flush=True)
    import torch
    from repro_torch._tree import to_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import Model
    S, B = 32, 2
    cfg = reduced(get_config(arch))
    model = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B,
                                                          "decode"),
                            remat="none"))
    params = model.init_params(torch.Generator().manual_seed(4))
    dparams = to_device(params, "cuda")
    batch = SyntheticLMData(cfg, ShapeProfile("t", S, B, "train"),
                            seed=4).batch(0)
    pb = {k: v[:, :S // 2] if k == "tokens" else v
          for k, v in batch.items() if k != "labels"}
    reset_counters()
    lc, cc = model.prefill(params, pb, model.init_cache())
    lg, cg = model.prefill(dparams, to_device(pb, "cuda"),
                           model.init_cache("cuda"))
    pairs = [(lc, lg.cpu())]
    tok = torch.argmax(lc, -1).to(torch.int32)
    for _ in range(2):    # teacher-forced with the CPU's greedy tokens
        lc, cc = model.decode_step(params, tok, cc)
        lg, cg = model.decode_step(dparams, tok.cuda(), cg)
        pairs.append((lc, lg.cpu()))
        tok = torch.argmax(lc, -1).to(torch.int32)
    serve_launches, _ = read_counters()
    logit_err = max(float((a - b).abs().max()) for a, b in pairs)
    print("  zoo_parity " + json.dumps({
        "arch": arch, "logits_max_abs_diff": logit_err,
        "logits_tol": ZOO_PARITY_TOL, "serve_launches": serve_launches}),
        flush=True)
    check(logit_err <= ZOO_PARITY_TOL,
          f"prefill and 2 decode steps' logits within {ZOO_PARITY_TOL}: "
          f"{logit_err:.3e}")
    want = zoo_launches(cfg)
    check(serve_launches == want,
          f"the card's prefill launched {serve_launches} = {want}, its "
          f"decodes none")
    del dparams
    train_step_parity(cfg, RunConfig(model=cfg, shape=ShapeProfile(
        "t", S, B, "train"), remat="full"), params, batch)


def attn_calls(path, cfg, B, S, enc_len=None):
    """The flash calls one forward of ``cfg`` over ``S`` positions makes
    (an encoder-decoder's also over ``enc_len`` frames), as (name,
    ``fa_case`` arguments) in the config's dtype."""
    mla = cfg.attn_type == "mla"
    H = cfg.heads_padded
    base = dict(B=B, H=H, dtype_name=cfg.dtype)
    calls = [(f"{path} decoder" if cfg.is_encoder_decoder else path, dict(
        base, S=S, KV=H if mla else cfg.kv_heads_padded,
        dq=cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if mla else cfg.hdim,
        dv=cfg.v_head_dim if mla else cfg.hdim, causal=True))]
    if cfg.is_encoder_decoder:
        enc = dict(base, KV=H, dq=cfg.hdim, dv=cfg.hdim, causal=False)
        calls += [(f"{path} encoder", dict(enc, S=enc_len)),
                  (f"{path} cross-attention", dict(enc, S=S, Skv=enc_len))]
    return calls


def zoo_plan():
    """The zoo's serve runs (config, run, requests), its train runs, and
    the shapes they give the kernels: flash at every call of each path
    (MLA's and cross-attention's serve shapes on the mma.sync and f32
    bodies too), the scan at each hybrid path's."""
    zoo_serve = []
    for arch, depth in ZOO_SERVE:
        zcfg, zrun = serve_config(arch, batch=2, n_layers=depth)
        zreqs = make_requests(zcfg, n=2, max_new=ZOO_SERVE_NEW, seed=2)
        zoo_serve.append((zcfg, zrun, zreqs))
    ecfg, erun = serve_config("seamless-m4t-medium", batch=2)
    erun = erun.with_(shape=dataclasses.replace(erun.shape, seq_len=512))
    e_prompt = 384
    zoo_train = [train_run(arch, seq, 2, n_layers=depth)
                 for arch, depth, seq in ZOO_TRAIN]
    zoo_train += [train_run(arch, 256, 2, small=True)
                  for arch in ("jamba-v0.1-52b", "deepseek-v3-671b")]
    paths = [(f"serve {c.name}", c, r.shape.global_batch, packed_len(r, q),
              None) for c, r, q in zoo_serve]
    paths.append((f"serve {ecfg.name}", ecfg, 2, e_prompt,
                  erun.shape.seq_len))
    paths += [(f"train {c.name}", c, r.shape.global_batch, r.shape.seq_len,
               r.shape.seq_len) for c, r in zoo_train]
    fa_zoo, ss_zoo = [], []
    for path, zcfg, B, S, enc_len in paths:
        serve = path.startswith("serve")
        for name, c in attn_calls(path, zcfg, B, S, enc_len):
            more = serve and (zcfg.attn_type == "mla" or "cross" in name)
            fa_zoo.append((name, c, ("mma", "f32") if more else ()))
        if zcfg.family == "hybrid":
            ss_zoo.append((path, (B, S, zcfg.d_inner, zcfg.ssm_state,
                                  zcfg.dt_rank_, zcfg.dtype)))
    return {"serve": zoo_serve, "encdec": (ecfg, erun, e_prompt),
            "train": zoo_train, "fa_cases": fa_zoo, "ss_cases": ss_zoo}


def zoo_paths(plan):
    """Serve (phases 10a-f) and train (11a-f) the zoo on the card, and
    hold each new family card against CPU (12); returns each kernel's
    launches by path."""
    by_path = {name: {} for name in kernel_counters()}

    def add_path(path, launches):
        for name, n in launches.items():
            if n:
                by_path[name][path] = n

    ecfg, erun, e_prompt = plan["encdec"]
    for i, (zcfg, zrun, zreqs) in enumerate(plan["serve"]):
        cut = ZOO_CUT.get((zcfg.name, "serve"), "full config")
        path = f"serve {zcfg.name}"
        add_path(path, timed(
            f"phase 10{'abcde'[i]}", on_path(path, phase_serve),
            f"10{'abcde'[i]}", zcfg, zrun, zreqs, zoo_launches(zcfg), cut))
    path = f"serve {ecfg.name}"
    add_path(path, timed(
        "phase 10f", on_path(path, phase_serve_encdec, runtime=False),
        "10f", ecfg, erun,
        e_prompt, ZOO_SERVE_NEW))
    for i, (zcfg, zrun) in enumerate(plan["train"]):
        path = f"train {zcfg.name}"
        add_path(path, timed(
            f"phase 11{'abcdef'[i]}", on_path(path, phase_train),
            f"11{'abcdef'[i]}", zcfg, zrun, train_launches(zcfg), 2,
            ZOO_CUT.get((zcfg.name, "train"), "")))
    for arch in ("internvl2-1b", "qwen2-moe-a2.7b", "minicpm3-4b",
                 "jamba-v0.1-52b", "seamless-m4t-medium", "deepseek-v3-671b"):
        timed(f"phase 12 ({arch})", phase_zoo_parity, "12", arch)
    return by_path


def timed(name, fn, *args):
    import torch
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"  [{name}: {time.perf_counter() - t0:.3f} s wall]", flush=True)
    # a phase's runtime, handles and spans form reference cycles that
    # hold its device values: collect them now, or the next phase's peak
    # device bytes would count them
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- multi-device steps on the card
# With one card, the multi-device steps run on a real NCCL group of world
# size 1 (16a, 16b; NCCL takes one process per device), and two gloo
# processes share the card (16c). Every run is held against the plain
# step by:
#   * the reference tests' loss bounds: 1e-3 (tests/test_grad_compress.py),
#     the pipeline's xent 2e-3 (tests/test_pipeline.py);
#   * its pre-clip grad_norm (the loss is taken before any sync, so this is
#     what sees the synced gradients), at rel 1e-4 where the arithmetic is
#     the plain step's up to f32 order (none, the pipeline, manual EP); bf16
#     rounds each element to within 2^-8 of itself, so its norm moves by at
#     most 2^-8 (rel) at one process, and the bound is twice that; int8
#     rounds each element to within its leaf's max/254, which measured
#     1.5e-3 on full tinyllama-1.1b at one process and 1.4e-4 on 16c
#     (NVIDIA H100 80GB HBM3, 700.00 W), and the bound is 1e-2: a sync that
#     kept each pod's own gradients (35% above the mean's norm on the CPU
#     tests' reduced tinyllama) or dropped the 1/n would miss it;
#   * its params, within one AdamW step's reach of the plain step's: a
#     first step moves an element by at most lr whatever its gradient, so
#     two steps differ by at most 2 lr and the rounding of the stored value
#     (this holds the update's size and its lr, not the gradients).
MP_LOSS_TOL, PP_XENT_TOL, MP_NONE_RTOL = 1e-3, 2e-3, 1e-4
GN_RTOL = {"none": MP_NONE_RTOL, "bf16": 2.0 ** -7, "int8": 1e-2,
           "pipeline": 1e-4, "manual_ep": 1e-4}
RANK_TIMEOUT = 420       # seconds for phase 16c's two processes


def max_leaf_diff(a, b):
    from repro_torch._tree import tree_leaves
    return max(float((x.float() - y.to(x.device).float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def adamw_first_step_ratio(a, b, lr):
    """The largest |a - b| of two params trees after one AdamW step from
    the same params, over its bound 2 lr plus the rounding of the stored
    values; at most 1 when both steps applied lr to unit updates."""
    import torch
    from repro_torch._tree import tree_leaves
    ratio = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        y = y.to(x.device)
        bound = 2 * lr * (1 + 1e-5) + torch.finfo(y.dtype).eps * (
            y.float().abs() + 2 * lr)
        ratio = max(ratio, float(((x.float() - y.float()).abs()
                                  / bound).max()))
    return ratio


def int8_wire_ok(byte_counts, params):
    """int8's all-gather hands over the int8 tensors and one f32 scale
    per leaf, nothing else (``byte_counts``: bytes by "op/dtype")."""
    from repro_torch._tree import tree_leaves
    leaves = tree_leaves(params)
    gathered = {k: v for k, v in byte_counts.items()
                if k.startswith("all_gather")}
    return gathered == {"all_gather/int8": sum(x.numel() for x in leaves),
                        "all_gather/float32": 4 * len(leaves)}


def multidevice_run(label, path, step, args, plain, plain_params, want,
                    gn_rtol, body="tma", gather=None):
    """One multi-device step on the main path ``path``: its wall time,
    peak device bytes, kernel launches (``want``, flash on ``body``) and
    the shape keys they had, the bytes handed to collectives, and its
    distance to the plain step: grad_norm within rel ``gn_rtol``, params
    within one AdamW step's reach."""
    import torch
    from repro_torch.parallel import _collectives as coll
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    coll.reset_counts()
    FA_SEEN.clear()
    _PATH[0] = path
    try:
        t0 = time.perf_counter()
        p2, opt2, m = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        _PATH[0] = None
    del opt2
    launches, by_body = read_counters()
    counts = coll.counts()
    peak = torch.cuda.max_memory_allocated()
    if gather is not None:
        p2 = gather(p2)
    m = {k: float(v) for k, v in m.items()}
    rec = {"run": label, "path": path, "s_per_step": wall,
           "peak_device_gb": peak / 1e9, "metrics": m,
           "loss_diff": abs(m["loss"] - plain["loss"]),
           "xent_diff": abs(m["xent"] - plain["xent"]),
           "loss_rel": abs(m["loss"] - plain["loss"]) / abs(plain["loss"]),
           "grad_norm_rel": abs(m["grad_norm"] - plain["grad_norm"])
           / plain["grad_norm"],
           "max_param_diff": max_leaf_diff(p2, plain_params),
           "param_diff_over_adamw_bound": adamw_first_step_ratio(
               p2, plain_params, plain["lr"]),
           "launches": launches, "flash_launches_by_body": by_body,
           "shape_keys": sorted(list(k) for k in FA_SEEN),
           "collective_bytes": counts["bytes"],
           "collective_calls": counts["calls"], "card": card_line()}
    print("  multidevice " + json.dumps(rec), flush=True)
    check(launches == want and by_body[body] == want["flash_attention_fwd"],
          f"{label}: launches {launches} = {want}, flash on the {body} "
          f"body")
    check(all(math.isfinite(v) for v in m.values()),
          f"{label}: finite metrics {m}")
    check(rec["grad_norm_rel"] <= gn_rtol,
          f"{label}: grad_norm within rel {gn_rtol:.3e} of the plain "
          f"step's ({rec['grad_norm_rel']:.3e})")
    check(rec["param_diff_over_adamw_bound"] <= 1.0,
          f"{label}: params within one AdamW step's reach of the plain "
          f"step's (max diff {rec['max_param_diff']:.3e}, "
          f"{rec['param_diff_over_adamw_bound']:.4f} of 2 lr + rounding)")
    del p2
    return rec


def phase_multidevice(cfg, run):
    """Phase 16a (the compressed-sync and pipelined steps of full-width
    tinyllama-1.1b on a world-1 NCCL mesh, each against the plain step)
    and 16b (its params saved from that mesh and restored elastically
    onto the host mesh with the fsdp placements)."""
    print("== phase 16a: multi-device train steps of tinyllama-1.1b (full "
          "config) on a world-1 NCCL mesh (pod 1, data 1, model 1)",
          flush=True)
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch._tree import to_device, tree_leaves
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.model_zoo import Model
    from repro_torch.optim.grad_compress import multipod_train_step
    from repro_torch.parallel.pipeline import (gather_stages,
                                               pipeline_train_step,
                                               split_stages)
    from repro_torch.parallel.sharding import distribute_tree
    model = Model(run)
    recs = []
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda:0"))
        try:
            mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
            check(dist.get_backend() == "nccl" and mesh.shape ==
                  {"pod": 1, "data": 1, "model": 1},
                  f"NCCL process group, mesh {mesh.shape}")
            params = model.init_params(torch.Generator(
                device="cuda").manual_seed(0), device="cuda")
            opt = model.opt_init(params)
            batch = to_device(SyntheticLMData(cfg, run.shape, seed=0)
                              .batch(0), "cuda")
            t0 = time.perf_counter()
            plain_p, plain_opt, pm = model.train_step(params, opt, batch)
            del plain_opt           # only its params are compared
            torch.cuda.synchronize()
            plain = {k: float(v) for k, v in pm.items()}
            print(f"  plain step {json.dumps(plain)} in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            want = train_launches(cfg)
            for method in ("none", "bf16", "int8"):
                rec = multidevice_run(
                    f"multipod {method}", f"16a multipod {method}",
                    multipod_train_step(model, mesh, method),
                    (params, opt, batch), plain, plain_p, want,
                    GN_RTOL[method])
                check(rec["loss_diff"] <= MP_LOSS_TOL,
                      f"multipod {method}: loss within {MP_LOSS_TOL} of "
                      f"the plain step ({rec['loss_diff']:.3e})")
                recs.append(rec)
            check(recs[0]["loss_rel"] <= MP_NONE_RTOL,
                  f"multipod none: loss within rel {MP_NONE_RTOL} "
                  f"({recs[0]['loss_rel']:.3e})")
            check(int8_wire_ok(recs[2]["collective_bytes"], params),
                  f"int8 hands only int8 tensors and f32 scales to the "
                  f"all-gather: {recs[2]['collective_bytes']}")
            n_micro = 2
            rec = multidevice_run(
                f"pipeline n_micro={n_micro}", "16a pipeline",
                pipeline_train_step(model, mesh, n_micro),
                (split_stages(params, mesh), split_stages(opt, mesh), batch),
                plain, plain_p, train_launches(cfg, n_micro),
                GN_RTOL["pipeline"], gather=lambda p: gather_stages(p, mesh))
            check(rec["xent_diff"] <= PP_XENT_TOL,
                  f"pipeline: xent within {PP_XENT_TOL} of the plain step "
                  f"({rec['xent_diff']:.3e})")
            check(rec["collective_calls"].get("ppermute", 0) > 0,
                  f"pipeline: the pipe rotated by ppermute "
                  f"({rec['collective_calls']})")
            recs.append(rec)
            del plain_p, opt
            gc.collect()
            torch.cuda.empty_cache()

            print("== phase 16b: elastic restore of tinyllama-1.1b's params "
                  "onto the host mesh (fsdp placements)", flush=True)
            t0 = time.perf_counter()
            ck = Checkpointer(os.path.join(tmp, "ck"))
            ck.save("tinyllama", 1, distribute_tree(
                params, model.param_shardings(mesh)),
                topology={"mesh": mesh.shape})
            t_save = time.perf_counter() - t0
            host = make_host_mesh()
            shardings = model.param_shardings(host)
            t0 = time.perf_counter()
            tree, meta = ck.restore("tinyllama", model.abstract_params(),
                                    shardings=shardings)
            t_restore = time.perf_counter() - t0
            leaves = tree_leaves(tree)
            same = all(a.full_tensor().dtype == b.dtype and torch.equal(
                a.full_tensor().view(torch.int16), b.view(torch.int16))
                for a, b in zip(leaves, tree_leaves(params))
                if b.dtype == torch.bfloat16) and all(
                torch.equal(a.full_tensor(), b)
                for a, b in zip(leaves, tree_leaves(params)))
            placed = {str(s.placements) for s in tree_leaves(shardings)}
            rb = {"save_s": t_save, "restore_s": t_restore,
                  "leaves": len(leaves), "meta": meta,
                  "placements": sorted(placed),
                  "device": str(leaves[0].to_local().device)}
            print("  restore " + json.dumps(rb, default=str), flush=True)
            check(same and leaves[0].to_local().is_cuda,
                  f"{len(leaves)} leaves restored on the card, every one "
                  f"bitwise the saved one")
            check(meta["step"] == 1 and meta["topology"] == {
                "mesh": mesh.shape}, f"metadata kept: {meta}")
            del tree, leaves, params
        finally:
            dist.destroy_process_group()
    return recs


# 16c: two gloo processes on the one card
def rank_16c(rank, world, workdir):
    """One of phase 16c's two processes (``chip_smoke.py --rank16c R W
    DIR``): the int8 multipod step of reduced tinyllama over (pod 2) and
    qwen2-moe-a2.7b's manual-EP step over (data 2), each against the plain
    step; writes its records and the shape keys it launched."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from repro_torch._tree import to_device
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import Model
    from repro_torch.optim.grad_compress import multipod_train_step
    sys.stdout = open(os.path.join(workdir, f"rank{rank}.out"), "w")
    torch.cuda.set_device(0)
    for mod in kernel_counters().values():
        mod.build()
    watch_launch_shapes()
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANK_TIMEOUT))
    out = []
    try:
        # (i) int8 over (pod 2), reduced tinyllama, f32
        cfg, run = train_run("tinyllama-1.1b", 16, 8, small=True)
        run = run.with_(remat="none", model=dataclasses.replace(cfg,
                                                                n_layers=2))
        cfg = run.model
        model = Model(run)
        params = model.init_params(torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda")
        opt = model.opt_init(params)
        batch = to_device(SyntheticLMData(cfg, run.shape).batch(0), "cuda")
        plain_p, _, pm = model.train_step(params, opt, batch)
        plain = {k: float(v) for k, v in pm.items()}
        mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), "cuda")
        rec = multidevice_run(
            "multipod int8, pod 2 (gloo, 2 processes)",
            "16c multipod int8 tinyllama (reduced)",
            multipod_train_step(model, mesh, "int8"), (params, opt, batch),
            plain, plain_p, {"flash_attention_fwd": 2,
                             "selective_scan_fwd": 0}, GN_RTOL["int8"],
            body="f32")
        rec["int8_wire_ok"] = int8_wire_ok(rec["collective_bytes"], params)
        out.append(rec)
        del params, opt, plain_p
        # (ii) qwen2-moe at full width, 2 layers: the expert all-to-all
        cfg, run = train_run("qwen2-moe-a2.7b", 1024, 2, n_layers=2)
        run = run.with_(moe_impl="manual_ep", opt_state_dtype="bfloat16")
        model = Model(run)
        params = model.init_params(torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda")
        opt = model.opt_init(params)
        batch = to_device(SyntheticLMData(cfg, run.shape).batch(0), "cuda")
        # on the host: compared leaf by leaf, it costs the card nothing
        ref = torch.load(os.path.join(workdir, "moe_plain.pt"),
                         map_location="cpu", weights_only=False)
        mesh = make_mesh((1, 2, 1), ("pod", "data", "model"), "cuda")
        rec = multidevice_run(
            "manual-EP step, data 2 (gloo, 2 processes)",
            "16c manual-EP qwen2-moe-a2.7b",
            multipod_train_step(model, mesh, "none"), (params, opt, batch),
            ref["metrics"], ref["params"], train_launches(cfg),
            GN_RTOL["manual_ep"])
        out.append(rec)
    finally:
        dist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump({"records": out, "launched": [
                [list(k), p] for k, p in
                LAUNCHED["flash_attention_fwd"].items()]}, f)
    return 0


def phase_two_processes():
    """Phase 16c: two gloo processes on the one card. The plain step of
    qwen2-moe-a2.7b (2 layers, AdamW bf16 state: two processes with f32
    state would not fit one card) runs here first; the processes' launched
    shape keys join phase 13's."""
    print("== phase 16c: two gloo processes on cuda:0: int8 multipod "
          "(pod 2, reduced tinyllama) and the expert all-to-all (data 2, "
          "qwen2-moe-a2.7b at full width, 2 of 24 layers)", flush=True)
    import tempfile
    import torch
    from repro_torch._tree import to_device
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import Model
    with tempfile.TemporaryDirectory() as tmp:
        cfg, run = train_run("qwen2-moe-a2.7b", 1024, 2, n_layers=2)
        run = run.with_(moe_impl="manual_ep", opt_state_dtype="bfloat16")
        model = Model(run)
        params = model.init_params(torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda")
        batch = to_device(SyntheticLMData(cfg, run.shape).batch(0), "cuda")
        t0 = time.perf_counter()
        p, opt, m = model.train_step(params, model.opt_init(params), batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        del opt
        torch.save({"params": p, "metrics": {k: float(v)
                                             for k, v in m.items()}},
                   os.path.join(tmp, "moe_plain.pt"))
        print(f"  plain qwen2-moe step {plain_s:.3f} s, "
              f"{json.dumps({k: float(v) for k, v in m.items()})}",
              flush=True)
        del params, p, m, batch
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  this process holds {torch.cuda.memory_reserved() / 1e9:.3f}"
              f" GB of the card", flush=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rank16c", str(r), "2", tmp], env=env)
                 for r in range(2)]
        t0 = time.perf_counter()
        try:
            while any(q.poll() is None for q in procs) and all(
                    q.returncode in (None, 0) for q in procs) and \
                    time.perf_counter() - t0 < RANK_TIMEOUT:
                time.sleep(0.2)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                q.wait()
            for r in range(2):
                log = os.path.join(tmp, f"rank{r}.out")
                if os.path.exists(log):
                    with open(log) as f:
                        for line in f.read().splitlines()[-40:]:
                            print(f"  [rank {r}] {line}", flush=True)
        check(all(q.returncode == 0 for q in procs),
              f"both 16c processes exited 0 in "
              f"{time.perf_counter() - t0:.3f} s")
        recs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res = json.load(f)
            for key, path in res["launched"]:
                LAUNCHED["flash_attention_fwd"].setdefault(tuple(key), path)
            recs.append(res["records"])
    for (tl, moe) in recs:
        check(tl["loss_diff"] <= MP_LOSS_TOL and tl["int8_wire_ok"],
              f"int8 over two processes: loss within {MP_LOSS_TOL} "
              f"({tl['loss_diff']:.3e}), only int8 and f32 scales on the "
              f"wire")
        check(moe["loss_diff"] <= MP_LOSS_TOL
              and moe["collective_calls"].get("all_to_all", 0) > 0,
              f"manual EP over two processes: loss within {MP_LOSS_TOL} "
              f"({moe['loss_diff']:.3e}), experts exchanged by all_to_all "
              f"({moe['collective_calls']})")
    return recs


# ----------------------------- 17: tensor parallelism, FSDP and the dry run
# 17a: full tinyllama-1.1b, bf16, over two gloo processes on the one card,
# against the plain single-process step on the card. Both sides are bf16
# and differ in the order of their sums (a product split over model sums
# its halves in bf16): the loss within rel 2e-3 (~0.02 at a loss of ~10.4,
# a bf16 loss's last bits); grad_norm within rel 2e-3, about 3x the
# largest reading (5.8e-4, dp_tp); each gradient leaf, read as AdamW's
# first moment (0.1 x the clipped gradient, f32), within rel 5e-2 of the
# plain step's leaf, norm-wise, about 3x the largest reading (1.65e-2,
# dp_tp, whose median leaf reads 1.5e-2: the bf16 roundings of the split
# products' sums compound over the 22 layers' backward; fsdp 7.5e-3),
# while a reduction lost or doubled (a Partial dropped) moves a leaf by
# rel 0.5 or more; params within one AdamW step's reach (which alone
# would not see a wrong gradient); logits at phase 4's bf16 bounds.
TP_SEQ, TP_BATCH = 2048, 2
TP_PROMPT, TP_CACHE, TP_DECODE = 256, 512, 4
TP_LAYOUTS = (((1, 2), "dp_tp"), ((2, 1), "fsdp"))
TP_LOSS_RTOL, TP_GNORM_RTOL, TP_GRAD_LEAF_RTOL = 2e-3, 2e-3, 5e-2
TP_TIMEOUT = 600        # seconds for 17a's two processes
DRYRUN_ARCHS = ("tinyllama-1.1b", "falcon-mamba-7b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_WORKERS = 4      # 17b's host processes, beside 17a's two


def tp_model(preset, kind="train"):
    """Full tinyllama-1.1b's Model: the train shape, or the serve one
    (cache of TP_CACHE positions)."""
    from repro_torch.models.model_zoo import Model
    cfg, run = train_run("tinyllama-1.1b", TP_SEQ, TP_BATCH)
    if kind != "train":
        from repro_torch.configs.base import ShapeProfile
        run = run.with_(shape=ShapeProfile("serve", TP_CACHE, TP_BATCH,
                                           "decode"))
    return Model(run.with_(sharding_preset=preset))


def tp_inputs(model):
    """(params drawn on the card from seed 0, the train batch, the
    prompt)."""
    import torch
    from repro_torch._tree import to_device
    from repro_torch.data.pipeline import SyntheticLMData
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
    batch = to_device(SyntheticLMData(model.cfg, model.run.shape, seed=0)
                      .batch(0), "cuda")
    return params, batch, {"tokens": batch["tokens"][:, :TP_PROMPT]}


def tp_serve(model, params, prompt, cache, tokens=None, place=lambda t: t):
    """The prefill and TP_DECODE decode steps: (logits, each on the host
    as f32, the greedy tokens; given ``tokens``, teacher-forced with
    them)."""
    import torch
    logits, cache = model.prefill(params, prompt, cache)
    out, toks = [logits], []
    for i in range(TP_DECODE):
        tok = torch.argmax(full(logits), -1).to(torch.int32) \
            if tokens is None else tokens[i].cuda()
        toks.append(tok.cpu())
        logits, cache = model.decode_step(params, place(tok), cache)
        out.append(logits)
    return [full(x).float().cpu() for x in out], toks


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def logits_agree(got, want):
    import torch
    a, b = torch.cat(want), torch.cat(got)
    return (float((b - a).norm() / a.norm()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def rank_17a(rank, world, workdir):
    """One of phase 17a's two processes (``chip_smoke.py --rank17a R W
    DIR``): each layout's train step, prefill and decode steps over
    DTensor-placed trees; writes its records and launched shape keys."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import _collectives as coll
    from repro_torch.parallel.sharding import distribute_tree, use_mesh
    sys.stdout = open(os.path.join(workdir, f"rank{rank}.out"), "w",
                      buffering=1)
    sys.stderr = sys.stdout
    torch.cuda.set_device(0)
    for mod in kernel_counters().values():
        mod.build()
    watch_launch_shapes()
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TP_TIMEOUT))
    out = {"records": []}
    try:
        plain = torch.load(os.path.join(workdir, "plain.pt"),
                           map_location="cpu", weights_only=False,
                           mmap=True)
        for shape, preset in TP_LAYOUTS:
            model = tp_model(preset)
            params, batch, prompt = tp_inputs(model)
            mesh = make_mesh(shape, ("data", "model"), "cuda")
            path = f"17a {preset} data {shape[0]} model {shape[1]}"
            # both processes drew the same params and batch: each takes
            # its shards of its own copy
            dp = distribute_tree(params, model.param_shardings(mesh), None)
            opt = distribute_tree(model.opt_init(params),
                                  model.opt_shardings(mesh), None)
            db = distribute_tree(batch, model.batch_shardings(mesh), None)
            del params
            local_gb = sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree_leaves(dp) + tree_leaves(opt)) / 1e9
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            coll.reset_counts()
            FA_SEEN.clear()
            _PATH[0] = path
            try:
                t0 = time.perf_counter()
                with use_mesh(mesh):
                    p2, opt, m = model.train_step(dp, opt, db)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                train_launches = read_counters()[0]
                reset_counters()
                serve = tp_model(preset, "serve")
                sh = serve.batch_shardings(mesh)
                t0 = time.perf_counter()
                with use_mesh(mesh):
                    logits, toks = tp_serve(
                        serve, dp, distribute_tree(
                            prompt, {"tokens": sh["tokens"]}, None),
                        distribute_tree(serve.init_cache("cuda"),
                                        serve.cache_shardings(mesh), None),
                        plain["tokens"], lambda t: distribute_tree(
                            t, serve.token_sharding(mesh), None))
                torch.cuda.synchronize()
                serve_s = time.perf_counter() - t0
            finally:
                _PATH[0] = None
            serve_launches = read_counters()[0]
            peak = torch.cuda.max_memory_allocated()
            counts = coll.counts()
            m = {k: float(v) for k, v in m.items()}
            p2 = [t.full_tensor() for t in tree_leaves(p2)]
            # each gradient leaf, as AdamW's first moment, against the
            # plain step's: rel norm of the difference
            grad_rel = []
            for t, w in zip(tree_leaves(opt["mu"]), plain["mu"]):
                w = w.cuda()
                grad_rel.append(float((t.full_tensor() - w).norm()
                                      / w.norm()))
            worst = max(range(len(grad_rel)), key=grad_rel.__getitem__)
            del opt, dp, db
            ratio = adamw_first_step_ratio(p2, plain["params"],
                                           plain["metrics"]["lr"])
            rel, agree = logits_agree(logits, plain["logits"])
            rec = {"path": path, "layout": {"data": shape[0],
                                            "model": shape[1]},
                   "preset": preset, "train_s": train_s, "serve_s": serve_s,
                   "peak_device_gb": peak / 1e9,
                   "local_params_and_state_gb": local_gb, "metrics": m,
                   "loss_rel": abs(m["loss"] - plain["metrics"]["loss"])
                   / abs(plain["metrics"]["loss"]),
                   "grad_norm_rel": abs(m["grad_norm"]
                                        - plain["metrics"]["grad_norm"])
                   / plain["metrics"]["grad_norm"],
                   "grad_leaf_rel_max": grad_rel[worst],
                   "grad_leaf_rel_worst": worst,
                   "grad_leaf_rel_median": sorted(grad_rel)[len(grad_rel)
                                                           // 2],
                   "param_diff_over_adamw_bound": ratio,
                   "logits_rel_err": rel, "argmax_agree": agree,
                   "launches": {k: train_launches[k] + serve_launches[k]
                                for k in train_launches},
                   "train_launches": train_launches,
                   "serve_launches": serve_launches,
                   "shape_keys": sorted(list(k) for k in FA_SEEN),
                   "collective_bytes": counts["bytes"],
                   "collective_calls": counts["calls"],
                   "card": card_line()}
            print("  tp " + json.dumps(rec), flush=True)
            out["records"].append(rec)
            del p2, logits
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump({**out, "launched": [
                [list(k), p] for k, p in
                LAUNCHED["flash_attention_fwd"].items()]}, f)
    return 0


def phase_tensor_parallel(beside=None):
    """Phase 17a: the plain step, prefill and decode steps of full
    tinyllama-1.1b in this process, then both layouts in two gloo
    processes on cuda:0, each held against them. The processes' launched
    shape keys join phase 13's. ``beside`` (phase 17b, host work that
    launches nothing) runs in this process while the two run; its result
    comes back with theirs."""
    print("== phase 17a: tensor parallelism and FSDP storage, full "
          "tinyllama-1.1b, two gloo processes on cuda:0: (data 1, model 2) "
          "dp_tp and (data 2, model 1) fsdp", flush=True)
    import tempfile
    import torch
    from repro_torch._tree import tree_leaves
    with tempfile.TemporaryDirectory() as tmp:
        model = tp_model("fsdp")
        params, batch, prompt = tp_inputs(model)
        t0 = time.perf_counter()
        p2, opt, m = model.train_step(params, model.opt_init(params), batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        mu = [t.cpu() for t in tree_leaves(opt["mu"])]
        del opt
        serve = tp_model("fsdp", "serve")
        logits, toks = tp_serve(serve, params, prompt,
                                serve.init_cache("cuda"))
        plain = {"params": [t.cpu() for t in tree_leaves(p2)], "mu": mu,
                 "metrics": {k: float(v) for k, v in m.items()},
                 "logits": logits, "tokens": toks}
        torch.save(plain, os.path.join(tmp, "plain.pt"))
        print(f"  plain step {plain_s:.3f} s, "
              f"{json.dumps(plain['metrics'])}", flush=True)
        del params, p2, batch, m, mu, plain
        gc.collect()
        torch.cuda.empty_cache()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rank17a", str(r), "2", tmp], env=env)
                 for r in range(2)]
        t0 = time.perf_counter()
        try:
            done = beside() if beside is not None else None
            while any(q.poll() is None for q in procs) and all(
                    q.returncode in (None, 0) for q in procs) and \
                    time.perf_counter() - t0 < TP_TIMEOUT:
                time.sleep(0.2)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                q.wait()
            for r in range(2):
                log = os.path.join(tmp, f"rank{r}.out")
                if os.path.exists(log):
                    with open(log) as f:
                        for line in f.read().splitlines()[-40:]:
                            print(f"  [rank {r}] {line}", flush=True)
        check(all(q.returncode == 0 for q in procs),
              f"both 17a processes exited 0 in "
              f"{time.perf_counter() - t0:.3f} s")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res = json.load(f)
            for key, path in res["launched"]:
                LAUNCHED["flash_attention_fwd"].setdefault(tuple(key), path)
            ranks.append(res)
    layers = model.cfg.n_layers
    for res in ranks:
        for rec in res["records"]:
            label = rec["path"]
            check(rec["loss_rel"] <= TP_LOSS_RTOL,
                  f"{label}: loss within rel {TP_LOSS_RTOL} of the plain "
                  f"step's ({rec['loss_rel']:.3e})")
            check(rec["grad_norm_rel"] <= TP_GNORM_RTOL,
                  f"{label}: grad_norm within rel {TP_GNORM_RTOL} "
                  f"({rec['grad_norm_rel']:.3e})")
            check(rec["grad_leaf_rel_max"] <= TP_GRAD_LEAF_RTOL,
                  f"{label}: every gradient leaf within rel "
                  f"{TP_GRAD_LEAF_RTOL} of the plain step's (largest "
                  f"{rec['grad_leaf_rel_max']:.3e}, leaf "
                  f"{rec['grad_leaf_rel_worst']}; median "
                  f"{rec['grad_leaf_rel_median']:.3e})")
            check(rec["param_diff_over_adamw_bound"] <= 1.0,
                  f"{label}: params within one AdamW step's reach "
                  f"({rec['param_diff_over_adamw_bound']:.4f})")
            check(rec["logits_rel_err"] <= LOGITS_REL_TOL
                  and rec["argmax_agree"] >= ARGMAX_AGREE_MIN,
                  f"{label}: prefill and {TP_DECODE} decode steps' logits "
                  f"rel err {rec['logits_rel_err']:.3e} <= "
                  f"{LOGITS_REL_TOL}, argmax {rec['argmax_agree']:.3f} >= "
                  f"{ARGMAX_AGREE_MIN}")
            # remat: forward and recompute per layer, then the prefill's
            want = 2 * layers + layers
            heads = model.cfg.n_heads // rec["layout"]["model"]
            rows = TP_BATCH // rec["layout"]["data"]
            local = [k for k in rec["shape_keys"]
                     if k[0] == rows and k[3] == heads]
            check(rec["launches"]["flash_attention_fwd"] == want and local,
                  f"{label}: flash launched {want} times "
                  f"({rec['launches']}), at the local shape "
                  f"({rows} rows, {heads} heads): {local}")
    return {"ranks": ranks, "beside": done}


def rank_17b(out_path, cells):
    """One of phase 17b's processes (``chip_smoke.py --cells17b OUT
    CELLS``): the dry run of each (arch, shape, mesh) cell in the JSON list
    CELLS, the records written to OUT."""
    from repro_torch.launch import dryrun
    recs = [dryrun.run_cell(arch, shape, mesh_kind, device="cuda")
            for arch, shape, mesh_kind in json.loads(cells)]
    with open(out_path, "w") as f:
        json.dump(recs, f)
    return 0


def phase_dryrun():
    """Phase 17b: the dry run on the card's path (fake CUDA tensors, a
    fake process group of 256 or 512 ranks): each cell ``ok``, one line
    per cell as the reference's ``main()`` prints, the kernels' FLOPs
    counted where their path runs them. The cells are host work on fake
    tensors: DRYRUN_WORKERS processes share them, each taking one
    train_4k cell (about 35 s) and two of the light ones."""
    print("== phase 17b: the dry run of tinyllama-1.1b and falcon-mamba-7b "
          "on the production meshes, fake CUDA tensors", flush=True)
    import tempfile
    from repro_torch.launch import dryrun
    cells = [(a, s, m) for a in DRYRUN_ARCHS for s in DRYRUN_SHAPES
             for m in ("single", "multi")]
    order = ([c for c in cells if c[1] == "train_4k"]
             + [c for c in cells if c[1] != "train_4k"])
    shares = [order[i::DRYRUN_WORKERS] for i in range(DRYRUN_WORKERS)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    by_cell = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, share in enumerate(shares):
            with open(os.path.join(tmp, f"w{i}.out"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--cells17b",
                     os.path.join(tmp, f"w{i}.json"), json.dumps(share)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            while any(q.poll() is None for q in procs) and all(
                    q.returncode in (None, 0) for q in procs) and \
                    time.perf_counter() - t0 < TP_TIMEOUT:
                time.sleep(0.2)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                q.wait()
        for i, q in enumerate(procs):
            if q.returncode != 0:
                with open(os.path.join(tmp, f"w{i}.out")) as f:
                    for line in f.read().splitlines()[-40:]:
                        print(f"  [17b process {i}] {line}", flush=True)
        check(all(q.returncode == 0 for q in procs),
              f"the {DRYRUN_WORKERS} 17b processes exited 0 in "
              f"{time.perf_counter() - t0:.3f} s")
        for i in range(DRYRUN_WORKERS):
            with open(os.path.join(tmp, f"w{i}.json")) as f:
                for rec in json.load(f):
                    by_cell[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    recs = []
    for arch, shape, mesh_kind in cells:
        rec = by_cell[(arch, shape, mesh_kind)]
        print("  " + dryrun.status_line(rec), flush=True)
        rec.pop("traceback", None) if rec["ok"] else None
        keep = ("arch", "shape", "mesh", "ok", "error", "chips",
                "memory", "per_device", "collectives",
                "collective_span", "kernel_flops", "roofline",
                "model_flops", "model_vs_hlo", "wall_s")
        print("  dryrun " + json.dumps({k: rec.get(k) for k in keep}),
              flush=True)
        check(rec["ok"], f"dry run {arch} x {shape} x {mesh_kind}: "
              f"{rec.get('error')}\n{rec.get('traceback', '')}")
        kind = dryrun.SHAPES[shape].kind
        kernel = ("flash_attention_fwd" if arch.startswith("tiny")
                  else "selective_scan_fwd")
        if kind != "decode":    # decode runs no kernel
            check(rec["kernel_flops"].get(kernel, 0) > 0,
                  f"{arch} x {shape} x {mesh_kind}: {kernel}'s "
                  f"FLOPs counted ({rec['kernel_flops']})")
        recs.append(rec)
    return recs


# ----------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    counters = kernel_counters()

    print("== phase 1: card and kernel builds", flush=True)
    card = card_line()
    print(f"  card: {card}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(counters)) as pool:   # one nvcc per source
        futs = {n: pool.submit(mod.build) for n, mod in counters.items()}
        libs = {n: str(f.result()) for n, f in futs.items()}
    print(f"  built {libs} in {time.perf_counter() - t0:.3f} s", flush=True)
    watch_launch_shapes()
    for lib in libs.values():       # registers and spills of each kernel
        info = Path(lib).with_suffix(".ptxas.txt")
        for line in info.read_text().splitlines() if info.exists() else []:
            if any(w in line for w in ("entry function", "registers",
                                        "spill")):
                print(f"  ptxas: {line.strip()}", flush=True)

    cfg, run = serve_config("tinyllama-1.1b")
    reqs = make_requests(cfg)
    fa_shape = (run.shape.global_batch, packed_len(run, reqs), cfg.n_heads,
                cfg.kv_heads, cfg.hdim)
    mcfg, mrun = serve_config("falcon-mamba-7b")
    mreqs = make_requests(mcfg, n=4, seed=1)
    ss_shape = (mrun.shape.global_batch, packed_len(mrun, mreqs),
                mcfg.d_inner, mcfg.ssm_state)
    tcfg, trun = train_run("tinyllama-1.1b", 2048, 4, grad_accum=2)
    fa_train = (trun.shape.global_batch // trun.grad_accum,
                trun.shape.seq_len, tcfg.n_heads, tcfg.kv_heads, tcfg.hdim)
    tmcfg, tmrun = train_run("falcon-mamba-7b", 1024, 2,
                             n_layers=MAMBA_TRAIN_LAYERS)
    ss_train = (tmrun.shape.global_batch, tmrun.shape.seq_len,
                tmcfg.d_inner, tmcfg.ssm_state)
    (fa, fa_long, fa_tr), (ss, ss_long, ss_tr) = timed(
        "phase 2", phase_kernels, (fa_shape, fa_train), (ss_shape, ss_train),
        mcfg.dt_rank_)

    plan = zoo_plan()
    fa_zoo_recs, ss_zoo_recs = timed("phase 2b", phase_kernels_zoo,
                                     plan["fa_cases"], plan["ss_cases"])

    check(cfg.n_layers == 22 and cfg.d_model == 2048
          and cfg.param_dtype == "bfloat16", "full tinyllama-1.1b config")
    fa_launches = timed("phase 3", on_path("serve tinyllama-1.1b",
                                           phase_serve), "3", cfg, run,
                        reqs, zoo_launches(cfg))
    timed("phase 4", phase_model_parity, "4", cfg)
    check(mcfg.n_layers == 64 and mcfg.d_model == 4096
          and mcfg.param_dtype == "bfloat16", "full falcon-mamba-7b config")
    ss_launches = timed("phase 3b", on_path("serve falcon-mamba-7b",
                                            phase_serve), "3b", mcfg, mrun,
                        mreqs, zoo_launches(mcfg))
    timed("phase 4b", phase_model_parity, "4b", mcfg)

    from repro_torch.apps.adjoint_tomography import FIG11, FIG12
    check((FIG11.nx, FIG11.ny, FIG11.nz, FIG12.nx, FIG12.ny, FIG12.nz,
           FIG11.nt, FIG12.nt, FIG11.n_receivers)
          == (104, 23, 24, 208, 44, 46, 200, 200, 16),
          "the paper's Fig 11 and Fig 12 meshes, nt=200, 16 receivers")
    fig11 = timed("phase 5 (Fig 11)", phase_at, FIG11)
    timed("phase 5 (Fig 12)", phase_at, FIG12)
    timed("phase 6", sanitized(f"adjoint tomography {FIG11.mesh_name} "
                               f"offloaded, fabric", phase_at_fabric),
          FIG11, fig11)
    fd_launches = timed("phase 7", on_path("frontdoor tinyllama-1.1b",
                                           phase_frontdoor), cfg, run)

    check(tcfg.n_layers == 22 and tcfg.d_model == 2048
          and tcfg.param_dtype == "bfloat16", "full tinyllama-1.1b config")
    fa_train_launches = timed(
        "phase 8", on_path("train tinyllama-1.1b", phase_train), "8", tcfg,
        trun,
        train_launches(tcfg, trun.grad_accum))
    check(tmcfg.d_model == 4096 and tmcfg.d_inner == 8192
          and tmcfg.ssm_state == 16 and tmcfg.param_dtype == "bfloat16",
          f"falcon-mamba-7b at full width, {MAMBA_TRAIN_LAYERS} of 64 "
          f"layers (the whole model with AdamW f32 state needs ~87 GB, "
          f"more than the card's 80 GB)")
    ss_train_launches = timed(
        "phase 8b", on_path("train falcon-mamba-7b", phase_train), "8b",
        tmcfg, tmrun,
        train_launches(tmcfg, tmrun.grad_accum), TRAIN_STEPS,
        f"{MAMBA_TRAIN_LAYERS} of 64 layers")
    timed("phase 9 (tinyllama)", phase_train_parity, "9", "tinyllama-1.1b")
    timed("phase 9 (falcon-mamba)", phase_train_parity, "9",
          "falcon-mamba-7b")

    # ---- the rest of the model zoo: serve, train, card against CPU
    by_path = {"flash_attention_fwd": {
        "serve tinyllama-1.1b": fa_launches["flash_attention_fwd"],
        "frontdoor tinyllama-1.1b": fd_launches["flash_attention_fwd"],
        "train tinyllama-1.1b": fa_train_launches["flash_attention_fwd"]},
        "selective_scan_fwd": {
        "serve falcon-mamba-7b": ss_launches["selective_scan_fwd"],
        "train falcon-mamba-7b": ss_train_launches["selective_scan_fwd"]}}

    for name, paths in zoo_paths(plan).items():
        by_path[name].update(paths)

    # ---- multi-device steps: world-1 NCCL mesh, then two processes
    check(trun.grad_accum == 2, "phase 8 trains in 2 microbatches")
    md = timed("phase 16a-b", phase_multidevice, tcfg,
               trun.with_(grad_accum=1))
    md_two = timed("phase 16c", phase_two_processes)
    fa_paths = by_path["flash_attention_fwd"]
    for rec in md + [r for rank in md_two for r in rank]:   # both of 16c's
        fa_paths[rec["path"]] = (fa_paths.get(rec["path"], 0)
                                 + rec["launches"]["flash_attention_fwd"])
    # 17b, the dry run (host work on fake tensors), runs here while 17a's
    # two processes run on the card
    tp = timed("phase 17a-b", phase_tensor_parallel,
               lambda: timed("phase 17b", phase_dryrun))
    for res in tp["ranks"]:                             # both processes'
        for rec in res["records"]:
            fa_paths[rec["path"]] = (fa_paths.get(rec["path"], 0)
                                     + rec["launches"]["flash_attention_fwd"])
    check(by_path["selective_scan_fwd"].get("serve jamba-v0.1-52b")
          and by_path["flash_attention_fwd"].get("serve jamba-v0.1-52b"),
          "the jamba serve path launched both kernels")
    unplanned = timed("phase 13", phase_launched_shapes)
    tenant_paths = timed("phase 15", phase_tenants, FIG11, fig11)
    meshes = [f"adjoint tomography {c.mesh_name}" for c in (FIG11, FIG12)]
    timed("phase 14", phase_sanitizer, [
        "serve tinyllama-1.1b", "serve falcon-mamba-7b",
        *(f"{m} {arm}" for m in meshes for arm in ("local", "offloaded")),
        f"{meshes[0]} offloaded, fabric", "frontdoor tinyllama-1.1b",
        "train tinyllama-1.1b", "train falcon-mamba-7b",
        *(f"serve {zcfg.name}" for zcfg, _, _ in plan["serve"]),
        *(f"train {zcfg.name}" for zcfg, _ in plan["train"]),
        *tenant_paths])

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "dtype", "profiler_ms",
            "host_us_per_call")
    bwd_keys = ("bwd_max_abs_err", "bwd_tol", "fwd_bwd_ms")

    def entry(name, source, replaces, by_path, rec, long_rec, train_rec,
              body):
        def at(r, extra=()):
            return {**{k: r[k] for k in keys + ("share_of_bound",) + extra},
                    "library_profiler_ms": r.get("library_profiler_ms")}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "body": body,
                **{k: rec[k] for k in keys},
                "library_profiler_ms": rec.get("library_profiler_ms"),
                "long_shape": at(long_rec),
                "train_shape": at(train_rec, bwd_keys)}

    record = {"kernels": [
        entry("flash_attention_fwd",
              "src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_fwd.cu",
              "src/repro/kernels/flash_attention/kernel.py:71",
              by_path["flash_attention_fwd"], fa, fa_long, fa_tr,
              fa["body"]),
        entry("selective_scan_fwd",
              "src/repro_torch/kernels/mamba_scan/csrc/selective_scan_fwd.cu",
              "src/repro/kernels/mamba_scan/kernel.py:54",
              by_path["selective_scan_fwd"], ss, ss_long, ss_tr,
              f"ss_fwd_kernel (bf16: state columns split over "
              f"{counters['selective_scan_fwd'].lanes(torch.bfloat16)} "
              f"lanes)")]}
    record["kernels"][0]["mma_body"] = fa["mma_body"]
    zoo_keys = keys + ("share_of_bound", "body", "library_profiler_ms")
    record["kernels"][0]["zoo_shapes"] = {
        name: {**{k: r.get(k) for k in zoo_keys + ("Skv",)},
               **{f"{b}_body": r[f"{b}_body"] for b in ("mma", "f32")
                  if f"{b}_body" in r}}
        for name, r in fa_zoo_recs.items()}
    record["kernels"][1]["zoo_shapes"] = {
        name: {k: r.get(k) for k in keys + ("share_of_bound",)}
        for name, r in ss_zoo_recs.items()}
    for i, kern in enumerate(record["kernels"]):
        kern["unplanned_shapes"] = [
            {k: r.get(k) for k in ("path", "body", "Skv", "kv_len")
             + keys[:8]} for r in unplanned if r["kernel"] == kern["name"]]
    print(f"  [total: {time.perf_counter() - t_start:.3f} s wall]",
          flush=True)
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank16c"]:      # one of phase 16c's processes
        sys.exit(rank_16c(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--rank17a"]:      # one of phase 17a's processes
        # CUDA tensors over gloo: the all-gather DTensor issues, which gloo
        # lacks for them, carried as a list all-gather (PERF.md §6)
        from repro_torch.parallel._collectives import carry_gloo_cuda
        with carry_gloo_cuda():
            rc = rank_17a(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(rc)
    if sys.argv[1:2] == ["--cells17b"]:     # one of phase 17b's processes
        sys.exit(rank_17b(sys.argv[2], sys.argv[3]))
    sys.exit(main())
