"""Plain Mamba-1 language model: forward, loss, gradients and AdamW.

The block is the one the configuration runs (``configs/falcon-mamba-7b*.json``):

    h   = RMSNorm(x) * ln1
    x_s, z = h W_in                          (d -> 2 d_inner)
    x_c = SiLU(causal depthwise conv_k(x_s) + b_conv)
    dt_r, B, C = x_c W_x                     (d_inner -> r + 2N)
    dt  = softplus(dt_r W_dt + b_dt)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   A = -exp(A_log)
    y_t = <h_t, C_t> + D x_t
    x   = x + (y * SiLU(z)) W_out

then RMSNorm and an untied head. Everything is computed in float32 from
the served weights. The scan is a chunked Hillis-Steele scan (products
of decays only, no division), checkpointed per chunk under autograd.

``quant="fp8"`` is the control: every matrix product's two inputs are
rounded to float8 e4m3 with one scale per tensor, as a lower-precision
path would run them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CHUNK = 64


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one per-tensor scale (straight-through
    under autograd)."""
    s = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    y = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (y - x.detach()) if x.requires_grad else y


def mm(x, w, quant):
    if quant == "fp8":
        x, w = fp8(x), fp8(w)
    return x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _pairs_scan(a, b):
    """Inclusive scan over dim 1 of h_t = a_t h_{t-1} + b_t (Hillis-Steele)."""
    T, k = a.shape[1], 1
    while k < T:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return a, b


def _scan_chunk(x, dt, A, B, C, D, h):
    a = torch.exp(dt[..., None] * A)                       # (Bt,T,di,N)
    b = (dt * x)[..., None] * B[:, :, None, :]
    a, b = _pairs_scan(a, b)
    hs = b + a * h[:, None]
    y = torch.einsum("btdn,btn->btd", hs, C) + D * x
    return y, hs[:, -1]


def scan(x, dt, A, B, C, D):
    """y (Bt,L,di) of the selective scan from a zero state."""
    Bt, L, di = x.shape
    h = x.new_zeros((Bt, di, A.shape[1]))
    ys = []
    for c0 in range(0, L, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        args = (x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], D, h)
        if torch.is_grad_enabled():
            y, h = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            y, h = _scan_chunk(*args)
        ys.append(y)
    return torch.cat(ys, 1)


def block(cfg: dict, p: Dict[str, torch.Tensor], x, quant=None):
    """One layer; ``p`` holds the layer's leaves by their mixer names."""
    di, n, r, k = (cfg["intermediate_size"], cfg["state_size"],
                   cfg["time_step_rank"], cfg["conv_kernel"])
    S = x.shape[1]
    h = rmsnorm(x, p["ln1/scale"], cfg["layer_norm_epsilon"])
    xz = mm(h, p["in_proj"], quant)
    xs, z = xz[..., :di], xz[..., di:]
    xp = F.pad(xs, (0, 0, k - 1, 0))
    xc = sum(xp[:, j:j + S] * p["conv_w"][j] for j in range(k)) + p["conv_b"]
    xc = F.silu(xc)
    proj = mm(xc, p["x_proj"], quant)
    dt = F.softplus(mm(proj[..., :r], p["dt_proj"], quant) + p["dt_bias"])
    Bm, Cm = proj[..., r:r + n], proj[..., r + n:]
    y = scan(xc, dt, -torch.exp(p["A_log"]), Bm, Cm, p["D"])
    return x + mm(y * F.silu(z), p["out_proj"], quant)


MIXER = "stage_0/pos_0/mixer/"


def layers(w: Dict[str, torch.Tensor]):
    """Each layer's leaves in float32, one layer at a time (one unbind per
    stacked leaf, so autograd stacks each leaf's gradient once)."""
    keys = [k for k in w if k.startswith("stage_0/")]
    per = {k: w[k].unbind(0) for k in keys}
    for i in range(len(per[keys[0]])):
        d = {k[len(MIXER):]: per[k][i].float() for k in keys
             if k.startswith(MIXER)}
        d["ln1/scale"] = per["stage_0/pos_0/ln1/scale"][i].float()
        yield d


def hidden(cfg, w, tokens, quant=None):
    """Final normed hidden states (B,S,d) over ``tokens`` (B,S)."""
    x = w["embed/embedding"][tokens.long()].float()
    for p in layers(w):
        x = block(cfg, p, x, quant)
    return rmsnorm(x, w["final_norm/scale"].float(), cfg["layer_norm_epsilon"])


def logits(cfg, w, tokens, quant=None, last_only=False):
    x = hidden(cfg, w, tokens, quant)
    if last_only:
        x = x[:, -1]
    return mm(x, w["embed/lm_head"].float(), quant)


def xent(z, labels):
    """Mean next-token cross-entropy: logits at t score labels[t+1]."""
    z = z[:, :-1]
    gold = torch.gather(z, -1, labels[:, 1:, None].long())[..., 0]
    return torch.mean(torch.logsumexp(z, -1) - gold)


# --------------------------------------------------------------- training
def cosine_lr(base: float, step: int, warmup: int = 100, total: int = 10_000,
              min_frac: float = 0.1) -> float:
    """The learning rate of 1-based step ``step``: linear warm-up, then a
    cosine to ``min_frac`` of ``base``."""
    if step < warmup:
        return base * min(step / max(warmup, 1), 1.0)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * t)))


def train(cfg: dict, w: Dict[str, torch.Tensor], batches: List[dict], hp: dict,
          quant: Optional[str] = None, rows: Optional[int] = None,
          keep_grads: bool = False) -> dict:
    """``len(batches)`` AdamW steps from the served weights ``w``.

    Each step's gradient is the mean over the batch's rows (taken in
    microbatches of ``hp["micro"]`` rows, which changes nothing but
    memory), clipped by its global norm, and applied by AdamW in float32
    with decoupled weight decay on leaves of two or more dims. After each
    step a leaf is stored in its served dtype. ``rows`` keeps only the
    first ``rows`` rows of every batch (a planted fault).

    Returns each step's loss, each leaf's norm of the first clipped
    gradient (with ``keep_grads`` the gradient itself, on the host), each
    leaf's norm of the change after the last step, and the first step's
    global gradient norm."""
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    store = {k: v.dtype for k, v in w.items()}
    params = {k: v.float().clone() for k, v in w.items()}
    start = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms, gnorm0, first = [], None, None, None
    for step, batch in enumerate(batches, start=1):
        toks = torch.as_tensor(batch["tokens"], device=params["embed/lm_head"].device)
        labs = torch.as_tensor(batch["labels"], device=toks.device)
        if rows is not None:
            toks, labs = toks[:rows], labs[:rows]
        n_micro = max(1, toks.shape[0] // hp["micro"])
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss_sum = 0.0
        for i in range(n_micro):
            sl = slice(i * hp["micro"], (i + 1) * hp["micro"])
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            with torch.enable_grad():
                loss = xent(logits(cfg, leaves, toks[sl], quant), labs[sl])
                g = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            for k, gi in zip(leaves, g):
                if gi is not None:
                    grads[k].add_(gi)
            loss_sum += float(loss.detach())
            del leaves, g, loss
        for k in grads:
            grads[k].div_(n_micro)
        losses.append(loss_sum / n_micro)
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(hp["grad_clip"] / (gnorm + 1e-9), max=1.0)
        lr = cosine_lr(hp["learning_rate"], step)
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        for k, p in params.items():
            g = grads[k] * scale
            mu[k] = b1 * mu[k] + (1 - b1) * g
            nu[k] = b2 * nu[k] + (1 - b2) * g * g
            upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
            if p.dim() >= 2:
                upd = upd + hp["weight_decay"] * p
            params[k] = (p - lr * upd).to(store[k]).float()
        if step == 1:
            gnorm0 = float(gnorm)
            grad_norms = {k: float(torch.linalg.vector_norm(grads[k] * scale))
                          for k in grads}
            if keep_grads:
                first = {k: (grads[k] * scale).cpu() for k in grads}
        del grads
    change = {k: float(torch.linalg.vector_norm(params[k] - start[k]))
              for k in params}
    return {"loss": losses, "grad_norm": grad_norms, "change": change,
            "global_grad_norm": gnorm0, "grads": first}
