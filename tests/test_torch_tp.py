"""Tensor parallelism over ``model`` and steps on FSDP-sharded storage on
the port (``Model.train_step``, ``prefill``, ``decode_step`` over
DTensor-placed trees under ``use_mesh``), held to the reference's plain
single-device JAX steps on the same params (converted leaf by leaf).

Layouts, each on gloo processes on the CPU: world 2 (data 1, model 2,
``dp_tp``), world 2 (data 2, model 1, ``fsdp``), world 4 (data 2, model 2,
``fsdp``). Architectures at 2 layers, reduced widths, f32: tinyllama with
6 q heads over 3 kv heads (the model axis splits the q heads 3 and 3 and
does not divide the kv heads, which stay whole, so each process gathers
the kv head each of its q heads reads), falcon-mamba-7b (the scan's
channels split over ``model``) and qwen2-moe-a2.7b (experts over
``model``, groups over ``data``).

Bounds: the train step's loss rel 1e-5, grad_norm rel 1e-4, every
updated param (gathered) within 1e-5; each gradient leaf, read as the
updated AdamW first moment (0.1 x the clipped gradient), within rel 1e-4
of the reference's leaf, norm-wise; the prefill's and two decode steps'
logits within 1e-4; each param's local shard the shape its pspec gives;
the outputs laid out as the inputs.

The params bound alone could not see a wrong gradient: a first AdamW
step moves each entry by about lr x sign(g), and lr is 3e-6 at step 1,
so any two gradients give params within 6e-6. The global grad_norm sees
only a fault large against the whole norm. Hence the per-leaf check.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeProfile as JShape
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.model_zoo import Model as JModel
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models.params import from_reference
from tests._torch_ranks import run_ranks

S, B = 16, 4
ARCHS = {"tinyllama-1.1b": dict(n_heads=6, n_kv_heads=3),
         "falcon-mamba-7b": {}, "qwen2-moe-a2.7b": {}}
LAYOUTS = {2: [((1, 2), "dp_tp"), ((2, 1), "fsdp")], 4: [((2, 2), "fsdp")]}
LOSS_RTOL, GNORM_RTOL, PARAM_ATOL, LOGITS_ATOL = 1e-5, 1e-4, 1e-5, 1e-4
GRAD_RTOL = 1e-4        # per leaf, of the reference leaf's norm


def _reference(arch):
    """The reference's params, plain train step and prefill + 2 greedy
    decode steps."""
    jcfg = jreduced(jget_config(arch), n_layers=2, **ARCHS[arch])
    jm = JModel(JRunConfig(model=jcfg, shape=JShape("t", S, B, "train")))
    jp = jm.init_params(jax.random.PRNGKey(0))
    batch = JData(jcfg, jm.run.shape).batch(0)
    p2, o2, met = jax.jit(jm.train_step)(jp, jm.opt_init(jp), batch)
    jd = JModel(JRunConfig(model=jcfg, shape=JShape("d", S, B, "decode")))
    pb = {k: v for k, v in batch.items() if k != "labels"}
    pb["tokens"] = pb["tokens"][:, :S // 2]
    logits, cache = jax.jit(jd.prefill)(jp, pb, jd.init_cache())
    all_logits, tokens = [np.asarray(logits)], []
    for _ in range(2):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        tokens.append(torch.from_numpy(np.array(tok)))
        logits, cache = jax.jit(jd.decode_step)(jp, tok, cache)
        all_logits.append(np.asarray(logits))
    return {"params": from_reference(jax.tree.map(np.asarray, jp)),
            "metrics": {k: float(v) for k, v in met.items()},
            "updated": [np.asarray(x) for x in jax.tree.leaves(p2)],
            "mu": [np.asarray(x) for x in jax.tree.leaves(o2["mu"])],
            "mu_paths": [jax.tree_util.keystr(k) for k, _ in
                         jax.tree_util.tree_flatten_with_path(o2["mu"])[0]],
            "logits": all_logits, "tokens": tokens}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs = {arch: _reference(arch) for arch in ARCHS}
    cfgs = {arch: reduced(get_config(arch), n_layers=2, **ARCHS[arch])
            for arch in ARCHS}
    inputs = {"S": S, "B": B,
              "params": {cfgs[a].name: refs[a]["params"] for a in ARCHS},
              "tokens": {cfgs[a].name: refs[a]["tokens"] for a in ARCHS}}
    ranks = {}
    for world, layouts in LAYOUTS.items():
        inputs["cases"] = [(cfgs[a], shape, preset) for shape, preset in
                           layouts for a in ARCHS]
        ranks[world] = run_ranks("tp", world,
                                 tmp_path_factory.mktemp(f"tp{world}"),
                                 inputs, timeout=300.0)
    return refs, cfgs, ranks


CASES = [(world, shape, preset, arch) for world, layouts in LAYOUTS.items()
         for shape, preset in layouts for arch in ARCHS]
IDS = [f"{arch}-data{shape[0]}-model{shape[1]}-{preset}"
       for _, shape, preset, arch in CASES]


def _case(runs, world, shape, preset, arch):
    refs, cfgs, ranks = runs
    key = (cfgs[arch].name, shape, preset)
    return refs[arch], [r[key] for r in ranks[world]]


@pytest.mark.parametrize("world,shape,preset,arch", CASES, ids=IDS)
def test_train_step_matches_reference(runs, world, shape, preset, arch):
    ref, ranks = _case(runs, world, shape, preset, arch)
    for rec in ranks:
        m = rec["metrics"]
        assert abs(m["loss"] - ref["metrics"]["loss"]) <= \
            LOSS_RTOL * abs(ref["metrics"]["loss"])
        assert abs(m["grad_norm"] - ref["metrics"]["grad_norm"]) <= \
            GNORM_RTOL * ref["metrics"]["grad_norm"]
        assert len(rec["params"]) == len(ref["updated"])
        for got, want in zip(rec["params"], ref["updated"]):
            np.testing.assert_allclose(got.numpy(), want, atol=PARAM_ATOL)
        assert rec["placements_kept"]


@pytest.mark.parametrize("world,shape,preset,arch", CASES, ids=IDS)
def test_each_gradient_leaf_matches_reference(runs, world, shape, preset,
                                              arch):
    """Each leaf's first moment after the step (0.1 x its clipped
    gradient, f32), gathered, against the reference's: the gradients'
    layouts (Partial sums reduced over data and model, the shards of a
    leaf split over model) leaf by leaf."""
    ref, ranks = _case(runs, world, shape, preset, arch)
    for rec in ranks:
        assert len(rec["mu"]) == len(ref["mu"])
        for path, got, want in zip(ref["mu_paths"], rec["mu"], ref["mu"]):
            err = float(np.linalg.norm(got.numpy() - want))
            scale = float(np.linalg.norm(want))
            assert scale > 0, path
            assert err <= GRAD_RTOL * scale, (path, err / scale)


@pytest.mark.parametrize("world,shape,preset,arch", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(runs, world, shape, preset,
                                            arch):
    ref, ranks = _case(runs, world, shape, preset, arch)
    for rec in ranks:
        assert len(rec["logits"]) == 3
        for got, want in zip(rec["logits"], ref["logits"]):
            np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL)


@pytest.mark.parametrize("world,shape,preset,arch", CASES, ids=IDS)
def test_local_shards_are_what_the_pspecs_say(runs, world, shape, preset,
                                              arch):
    """Every param leaf's local shard: each dim its global size over the
    product of the mesh axes its pspec entry names (all divide: the
    rules' divisibility fallback), and some leaf split where the mesh
    has an axis above 1."""
    ref, ranks = _case(runs, world, shape, preset, arch)
    sizes = dict(zip(("data", "model"), shape))
    for rec in ranks:
        assert len(rec["shards"]) == len(_tree.tree_leaves(ref["params"]))
        split = False
        for glob, local, spec in rec["shards"]:
            want = list(glob)
            for d, entry in enumerate(spec):
                names = (entry,) if isinstance(entry, str) else entry or ()
                n = math.prod(sizes[a] for a in names)
                assert glob[d] % n == 0
                want[d] //= n
            assert local == tuple(want), (glob, spec)
            split |= local != glob
        assert split
