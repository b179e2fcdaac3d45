#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (CUDA_HOME, default /usr/local/cuda) and the
checkout's ``src/``; it builds every kernel from the sources at first use.
Phases, each of which fails the run (non-zero exit) on a failed check:

  1. print the card (name, power limit) and build the kernels, timed;
  2. hold each kernel against its plain PyTorch version on the card, over
     the reference's test sweep plus the serve path's shape, with times
     for the kernel, the plain version, one PyTorch library call computing
     the same function, and the bound (least time the card could take);
  3. serve tinyllama-1.1b at its full config (22 layers, d_model 2048,
     bf16, random weights from a seed) through
     ``repro_torch.launch.serve.Server`` and the port's EmeraldRuntime,
     with the cloud tier on the card: 8 requests of 384-512 prompt tokens,
     32 new tokens each. Kernel launch counts are reset just before and
     read just after;
  4. run the same model at 2 layers, full width, on the card (bf16, kernel)
     and on the CPU (f32, plain version) from one param tree, and compare
     the logits.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
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
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# logits of a 2-layer full-width model, bf16 on the card vs f32 on the
# CPU: bf16 keeps ~3 significant digits per rounding, so a norm-wise
# relative error of a few 1e-3 is expected; 5e-2 fails only a real fault
LOGITS_REL_TOL = 5e-2
ARGMAX_AGREE_MIN = 0.75


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


# ------------------------------------------------------------ flash attention
def fa_bound_ms(B, Sq, Skv, H, KV, dq, dv, dtype, causal, kv_len):
    """Least time for the call: bytes of q, k, v read once and o written
    once over HBM bandwidth, or the visible (q, k) pairs' two products
    over the peak rate of the inputs' type; the larger bounds it."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (B * Sq * H * dq + B * Skv * KV * (dq + dv)
                      + B * Sq * H * dv)
    kv_len = Skv if kv_len is None else kv_len
    pairs = sum(min(kv_len, q + 1) if causal else kv_len for q in range(Sq))
    ops = B * H * pairs * 2 * (dq + dv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fa_case(B, S, H, KV, dq, dv, dtype_name, causal, kv_len=None):
    """Kernel vs plain version on one seeded input, both timed; returns
    the record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref
    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, S, H, dq), generator=g).to("cuda", dt)
    k = torch.randn((B, S, KV, dq), generator=g).to("cuda", dt)
    v = torch.randn((B, S, KV, dv), generator=g).to("cuda", dt)
    scale = dq ** -0.5
    out = kernel.flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                     kv_len=kv_len)
    want = ref.attention_ref(q, k, v, scale=scale, causal=causal,
                             kv_len=kv_len)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    tol = TOL[dtype_name]
    good = bool(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol))
    rec = {"shape": [B, S, H, KV, dq, dv], "dtype": dtype_name,
           "causal": causal, "kv_len": kv_len, "max_abs_err": err,
           "tol": tol, "ok": good}
    rec["ms"] = cuda_ms(lambda: kernel.flash_attention_fwd(
        q, k, v, scale=scale, causal=causal, kv_len=kv_len))
    rec["plain_ms"] = cuda_ms(lambda: ref.attention_ref(
        q, k, v, scale=scale, causal=causal, kv_len=kv_len))
    rec["library_ms"] = None
    if kv_len is None and dq == dv:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale,
                enable_gqa=KV != H))
    rec["bound_ms"], rec["bound_by"] = fa_bound_ms(
        B, S, S, H, KV, dq, dv, dtype_name, causal, kv_len)
    return rec


def phase_kernels(serve_shape):
    print("== phase 2: kernels against their plain versions on the card",
          flush=True)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    slice_rec = fa_case(B=B, S=S, H=H, KV=KV, dq=D, dv=D,
                        dtype_name="bfloat16", causal=True)
    print("  flash_attention_fwd (serve shape) " + json.dumps(slice_rec),
          flush=True)
    torch.cuda.synchronize()
    bad = [r for r in recs + [slice_rec] if not r["ok"]]
    check(not bad, f"flash_attention_fwd agrees with attention_ref on "
          f"{len(recs) + 1} cases (f32 2e-5, bf16 2e-2)"
          + (f"; failing: {bad}" if bad else ""))
    return slice_rec


# ---------------------------------------------------------------------- serve
def serve_config():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeProfile
    cfg = get_config("tinyllama-1.1b")
    return cfg, RunConfig(model=cfg, shape=ShapeProfile("serve", 2048, 4,
                                                        "decode"),
                          remat="none")


def make_requests(cfg, n=8, max_new=32, seed=0):
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(0, cfg.vocab_size, int(
        rng.integers(384, 513))).astype(np.int32), max_new=max_new)
        for rid in range(n)]


def phase_serve(cfg, run, reqs):
    print("== phase 3: serve tinyllama-1.1b (full config) through the "
          "Emerald runtime on the card", flush=True)
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.cloud.wire import manifest_of
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.serve import Server
    from repro_torch.models.model_zoo import Model

    check(cfg.n_layers == 22 and cfg.d_model == 2048
          and cfg.param_dtype == "bfloat16", "full tinyllama-1.1b config")
    t0 = time.perf_counter()
    params = Model(run).init_params(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  params: {n_params} on the host ({cfg.param_dtype}), init "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    srv = Server(run, params)
    check(srv.tiers["cloud"].device.type == "cuda", "cloud tier on the card")
    prefill_s, decode_s, logits_seen = [], [], []
    run_prefill, submit_decode = srv.ex_prefill.run, srv.ex_decode.submit

    def timed_prefill(*a, **k):
        t = time.perf_counter()
        out = run_prefill(*a, **k)
        prefill_s.append(time.perf_counter() - t)
        logits_seen.append(out["logits"])
        return out

    class _Timed:
        def __init__(self, handle, t):
            self.handle, self.t = handle, t

        def result(self, *a, **k):
            out = self.handle.result(*a, **k)
            decode_s.append(time.perf_counter() - self.t)
            logits_seen.append(out["logits"])
            return out

    srv.ex_prefill.run = timed_prefill
    srv.ex_decode.submit = lambda *a, **k: _Timed(submit_decode(*a, **k),
                                                  time.perf_counter())
    for r in reqs:
        srv.submit(r)
    kernel.launches = 0
    t0 = time.perf_counter()
    try:
        done = []
        while srv.queue:
            done += srv.step_batch()
        serve_s = time.perf_counter() - t0
        launches = {"flash_attention_fwd": kernel.launches}
        rep = srv.transfer_report()
        spans = srv.runtime.tracer.spans()
        # the cost of hashing what the serve path puts (trouble spot of
        # the port): the host params and one device KV cache
        t = time.perf_counter()
        manifest_of(params)
        params_hash_s = time.perf_counter() - t
        cache = srv.mdss.peek_latest("cache")[0]
        cache_bytes = sum(x.nbytes for x in tree_leaves(cache))
        t = time.perf_counter()
        manifest_of(cache)
        cache_hash_s = time.perf_counter() - t
    finally:
        srv.close()

    B = run.shape.global_batch
    check(len(done) == len(reqs)
          and all(len(r.tokens) == 32 for r in done),
          f"{len(done)} requests got 32 tokens each")
    check(all(bool(torch.isfinite(l).all()) for l in logits_seen)
          and all(tuple(l.shape) == (B, cfg.vocab_padded)
                  for l in logits_seen),
          f"{len(logits_seen)} fetched logits are finite, ({B}, "
          f"{cfg.vocab_padded})")
    check(launches["flash_attention_fwd"] == cfg.n_layers
          * srv.stats["prefills"],
          f"flash launches {launches['flash_attention_fwd']} = "
          f"{cfg.n_layers} layers x {srv.stats['prefills']} prefills")
    check(rep["decode_offloads"] == srv.stats["decode_calls"],
          f"every decode was an offload ({rep['decode_offloads']})")
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
        "requests": len(done), "prompt_lens": [len(r.prompt) for r in reqs],
        "prefills": srv.stats["prefills"],
        "decode_calls": srv.stats["decode_calls"],
        "prefill_s": prefill_s,
        "decode_ms_per_token": 1e3 * sum(decode_s) / max(len(decode_s), 1),
        "tokens_out": out_tokens, "serve_s": serve_s,
        "tokens_per_s": out_tokens / serve_s,
        "span_s": tot, **by_step,
        "bytes_moved": {f"{a}->{b}": n
                        for (a, b), n in rep["bytes_moved"].items()},
        "params_hash_s": params_hash_s, "params_bytes": sum(
            x.nbytes for x in tree_leaves(params)),
        "cache_hash_s": cache_hash_s, "cache_bytes": cache_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    print("  serve " + json.dumps(stats), flush=True)
    return launches


# ----------------------------------------------------------- model vs plain
def phase_model_parity(cfg):
    print("== phase 4: 2-layer full-width model, card (bf16, kernel) vs "
          "CPU (f32, plain)", flush=True)
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs.base import RunConfig, ShapeProfile
    from repro_torch.models.model_zoo import Model
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                dtype="float32")
    cfg16 = dataclasses.replace(cfg32, param_dtype="bfloat16",
                                dtype="bfloat16")
    shape = ShapeProfile("parity", 256, 4, "decode")
    m32 = Model(RunConfig(model=cfg32, shape=shape, remat="none"))
    m16 = Model(RunConfig(model=cfg16, shape=shape, remat="none"))
    p32 = m32.init_params(torch.Generator().manual_seed(1))
    p16 = tree_map(lambda t: t.to("cuda", torch.bfloat16), p32)
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
    print("  parity " + json.dumps({"rel_err": rel, "rel_tol": LOGITS_REL_TOL,
                                    "argmax_agree": agree,
                                    "argmax_min": ARGMAX_AGREE_MIN,
                                    "rows": int(a.shape[0])}), flush=True)
    check(bool(torch.isfinite(b).all()), "card logits finite")
    check(rel <= LOGITS_REL_TOL,
          f"logits rel err {rel:.3e} <= {LOGITS_REL_TOL}")
    check(agree >= ARGMAX_AGREE_MIN,
          f"argmax agreement {agree:.3f} >= {ARGMAX_AGREE_MIN}")


# ----------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import kernel

    print("== phase 1: card and kernel builds", flush=True)
    card = card_line()
    print(f"  card: {card}", flush=True)
    builds = {"flash_attention_fwd": kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:    # one nvcc per source
        futs = {n: pool.submit(fn) for n, fn in builds.items()}
        libs = {n: str(f.result()) for n, f in futs.items()}
    print(f"  built {libs} in {time.perf_counter() - t0:.3f} s", flush=True)
    for lib in libs.values():       # registers and spills of each kernel
        info = Path(lib).with_suffix(".ptxas.txt")
        for line in info.read_text().splitlines() if info.exists() else []:
            if any(w in line for w in ("entry function", "registers",
                                        "spill")):
                print(f"  ptxas: {line.strip()}", flush=True)

    cfg, run = serve_config()
    reqs = make_requests(cfg)
    B = run.shape.global_batch
    plen = min(len(r.prompt) for r in reqs[:B])    # first batch's packing
    serve_shape = (B, plen, cfg.n_heads, cfg.kv_heads, cfg.hdim)
    fa = phase_kernels(serve_shape)
    launches = phase_serve(cfg, run, reqs)
    phase_model_parity(cfg)

    record = {"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": fa["max_abs_err"], "ms": fa["ms"],
        "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
        "shape": fa["shape"], "dtype": fa["dtype"]}]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
