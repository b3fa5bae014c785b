"""Sharded prefill and decode on the CPU: one spawn of 4 ``gloo`` processes
runs every plan below as one rank each -- ``serve.prefill``,
``serve.serve_step`` and the greedy loop with ``par`` --, held against the
single-process prefill and decode from the same parameters, and against
the JAX package's own sharded prefill and decode step (a subprocess on 4
host devices, the construction of ``repro/launch/dryrun.py:77-116``).

Plans (``CASES``: arch, replaced config fields, mesh, global batch,
prompt length, cache length, serving weights over data):

* GQA sharded by head (llama3.2-3b smoke, 8/4 heads) on (2, 2);
* the head_dim / seq fallback: starcoder2-3b smoke with 1 KV head on
  (2, 2), and as it is (8/2 heads) on (1, 4), its 16-slot window ring;
* a global batch of 1 on the data axes, the cache split over the
  sequence: on (4, 1) and, with the fallback, on (2, 2), each without a
  window (llama3.2-3b, 32 slots) and with one (starcoder2-3b, 16 slots,
  wrapped by the last decode step);
* MLA with MoE (deepseek-v2 smoke: 4 heads, 2 experts and the shared
  expert a rank), and the same with the serving weights split over the
  data axes too (gathered before use);
* Mamba2 (mamba2-130m smoke: 8 SSD heads a rank, a conv window slice of
  272 channels that cuts a head);
* the jamba hybrid (1 KV head: the fallback, SSM and MoE layers);
* a ("pod", "data", "model") mesh (2, 1, 2) with mixtral-8x22b smoke
  (window ring, expert-parallel MoE).

Tolerances: logits and caches within 2e-5 of their max |value| in
float32 and 2e-2 in bfloat16 (the attention kernels' tolerances,
tests/test_kernels.py:29 of the JAX package): the ranks sum the same
products in other orders, and a decode merges its ranks' partial
softmaxes by their log-sum-exp.  Four float32 greedy steps (the prefill
and three decode steps) give the same tokens; the bfloat16 steps decode
the same teacher-forced tokens on both sides.  Every local cache leaf has
its spec's shard shape (``col.local_shape``).  Float32 routes every MoE
token as the single process does.  In bfloat16 a router's top-k may flip
where two experts' probabilities are close (the ranks add the mixers'
bf16 partial outputs over the model axis), so the single-process
bfloat16 run dispatches to the experts the ranks picked (``routing``'s
``force``) and every row is compared; where its own top-k differs from
theirs, its gap between the k-th and the next probability must be under
``NEAR_TIE``.  The jamba hybrid is held in float32 only (``DTYPES``).

The same spawn holds ``merge_decode_partials`` and
``vocab_parallel_argmax`` on 4 ranks against the whole-cache softmax and
``torch.argmax`` (a rank with no valid slot, a row no rank has one of,
ties across ranks), and this file holds ``gqa_decode_ref(...,
return_lse=True)`` against the whole-cache softmax.
"""
import contextlib
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_decode import gqa_decode_ref, gqa_decode_splitk
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import init_params
from repro_torch.models import moe
from repro_torch.models.transformer import cache_shapes, local_cache_specs
from repro_torch.parallel import collectives as col
from repro_torch.models import param_shapes
from repro_torch.parallel import sharding as sh
from repro_torch.serve import greedy_decode, serve_parallel
from repro_torch.train.optimizer import tree_map
from test_torch_multirank_harness import (  # noqa: F401 (one_thread: autouse)
    close, join_ranks, one_thread, serve_run, spawn_ranks, start_jax_serve)

WORLD = 4
SEED = 5
STEPS = 4                   # the prefill's token and three decode steps
TOL = {"fp32": 2e-5, "bf16": 2e-2}
# the largest gap between a MoE row's k-th and next routing probability
# (single process, bfloat16) at which the ranks may pick other experts:
# deepseek-v2 smoke's one flip is at a gap of 1.1e-4
NEAR_TIE = 1e-3
# key: (arch, replaced config fields, mesh, global batch, prompt length,
# cache length, serving weights over the data axes)
CASES = {
    "llama-heads-2x2": ("llama3.2-3b", {}, (2, 2), 4, 8, 16, False),
    "starcoder2-kv1-fallback-2x2": ("starcoder2-3b", {"num_kv_heads": 1},
                                    (2, 2), 4, 8, 24, False),
    "starcoder2-fallback-1x4": ("starcoder2-3b", {}, (1, 4), 2, 8, 24,
                                False),
    "llama-seq-4x1": ("llama3.2-3b", {}, (4, 1), 1, 12, 32, False),
    "starcoder2-seq-window-4x1": ("starcoder2-3b", {}, (4, 1), 1, 14, 24,
                                  False),
    "llama-kv1-seq-fallback-2x2": ("llama3.2-3b", {"num_kv_heads": 1},
                                   (2, 2), 1, 12, 32, False),
    "starcoder2-kv1-seq-window-fallback-2x2": (
        "starcoder2-3b", {"num_kv_heads": 1}, (2, 2), 1, 14, 24, False),
    "deepseek-mla-moe-2x2": ("deepseek-v2-236b", {}, (2, 2), 4, 8, 16,
                             False),
    "deepseek-weights-over-data-2x2": ("deepseek-v2-236b", {}, (2, 2), 4, 8,
                                       16, True),
    "mamba2-2x2": ("mamba2-130m", {}, (2, 2), 4, 8, 16, False),
    "jamba-kv1-2x2": ("jamba-1.5-large-398b", {"num_kv_heads": 1}, (2, 2),
                      2, 8, 16, False),
    "mixtral-pod-2x1x2": ("mixtral-8x22b", {}, (2, 1, 2), 2, 8, 24, False),
}
# jamba is held in float32 only: over its 16 smoke sub-layers the
# single-process bfloat16 logits are themselves 2.3-4.1% of max |logit|
# from the float32 ones, above TOL["bf16"], with the MoE layers on the same
# experts; the sharded run is as far (2.5-4.5%)
DTYPES = {key: ("fp32",) if CASES[key][0] == "jamba-1.5-large-398b"
          else tuple(TOL) for key in CASES}
# the JAX package's sharded prefill and decode step on 4 host devices
JAX_CASES = list(CASES)


def config(key):
    arch, fields = CASES[key][:2]
    return dataclasses.replace(smoke_config(arch), **fields)


def params_of(cfg, dtype):
    params = init_params(cfg, SEED, device="cpu")
    if dtype == "fp32":
        params = tree_map(lambda p: p.float(), params)
    return params


def prompts(cfg, b, s):
    return torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, s)))


def forced(cfg, b):
    """The bfloat16 runs' decode tokens (b, STEPS - 1)."""
    return torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (b, STEPS - 1)))


class _ForcedTopk:
    """``torch`` for ``models.moe`` with its ``topk`` replaced by the given
    experts (b, s, k) and their probabilities."""

    def __init__(self, idx):
        self.idx = idx

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, probs, k, dim=-1):
        assert self.idx.shape == probs.shape[:-1] + (k,)
        return torch.gather(probs, dim, self.idx), self.idx


@contextlib.contextmanager
def routing(out, force=None):
    """Record each MoE call's top-k experts (b, s, k), sorted, and the gap
    between the k-th and the next probability (b, s) into ``out`` as
    "route{c}" and "gap{c}" for its c-th call.  With ``force`` ({"route{c}":
    experts}) the c-th call dispatches to ``force``'s experts instead,
    recorded as "forced{c}".  The order of a token's k experts changes no
    output: each expert's slots follow the token order, and the k outputs
    are summed in float32."""
    ffn = moe.moe_ffn

    def spy(cfg, p, x, par=None):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1)
        c = sum(1 for n in out if n.startswith("route"))
        out[f"route{c}"] = top.indices[..., :cfg.top_k].sort(-1).values.numpy()
        out[f"gap{c}"] = (top.values[..., -2] - top.values[..., -1]).numpy()
        if force is None:
            return ffn(cfg, p, x, par)
        out[f"forced{c}"] = force[f"route{c}"]
        moe.torch = _ForcedTopk(torch.from_numpy(force[f"route{c}"]))
        try:
            return ffn(cfg, p, x, par)
        finally:
            moe.torch = torch

    moe.moe_ffn = spy
    try:
        yield
    finally:
        moe.moe_ffn = ffn


def run(cfg, params, prompt, cache_len, dtype, par=None, rows=slice(None),
        force=None):
    """The serving path on rows ``rows`` of the global batch ``prompt``:
    prefill, then STEPS - 1 decode steps on its greedy tokens (fp32) or on
    ``forced``'s (bf16), its MoE layers on ``force``'s experts if given
    (``routing``).  {"logits{i}", "prefill/..." and "decode/..." cache
    leaves, "step1/..." after the first decode step, "tokens", "route{c}",
    "gap{c}" and "forced{c}"} as numpy arrays."""
    out = {}
    with routing(out, force):
        out.update(serve_run(cfg, params, prompt[rows], cache_len,
                             STEPS - 1, par, feed=None if dtype == "fp32"
                             else forced(cfg, prompt.shape[0])[rows]))
    return out


def rows_of(key, coords, sizes):
    """The rows of the global batch a rank with ``coords`` holds."""
    B = CASES[key][3]
    nd = math.prod(n for a, n in sizes.items() if a != "model")
    if B % nd:
        return slice(None)
    idx = col._axis_index(tuple(a for a in ("pod", "data") if a in sizes),
                          sizes, coords)[0]
    return slice(idx * B // nd, (idx + 1) * B // nd)


def mesh_sizes(key):
    shape = CASES[key][2]
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return dict(zip(names, shape))


def _plan(key, rank_out):
    """One plan on this rank: its fp32 and bf16 runs, saved, and the
    local cache leaves whose shapes are off their specs' shards."""
    arch, _, shape, B, P, L, zero_data = CASES[key]
    cfg = config(key)
    pods = shape[0] if len(shape) == 3 else 1
    mesh = make_plan_mesh(*shape[-2:], device_type="cpu", pods=pods)
    coords = col.mesh_coords(mesh)
    sizes = mesh_sizes(key)
    par = serve_parallel(cfg, mesh, B, L, zero_data=zero_data)
    specs = sh.param_specs(cfg, param_shapes(cfg), mesh, zero_data=zero_data)
    rows = rows_of(key, coords, sizes)
    cspecs = local_cache_specs(cfg, B, L, mesh)
    full = {}
    out = {"coords": coords, "bad": []}
    for dtype in DTYPES[key]:
        params = params_of(cfg, dtype)
        local = col.map_specs(lambda t, s, name: col.shard_leaf(
            t, s, mesh, coords, name=name, ssm_heads=cfg.n_ssm_heads),
            params, specs)
        res = run(cfg, local, prompts(cfg, B, P), L, dtype, par, rows)
        if dtype == "fp32":
            full = res
            res["greedy"] = greedy_decode(cfg, local, prompts(cfg, B, P)[rows],
                                          STEPS, L, par).numpy()
        np.savez(os.path.join(rank_out, f"{key}-{dtype}.npz"), **res)
    for sub, leaves in cache_shapes(cfg, B, L).items():
        for name, whole in leaves.items():
            want = col.local_shape(whole, cspecs[sub][name], sizes)
            for tag in ("prefill", "decode"):
                got = full[f"{tag}/{sub}/{name}"].shape
                if tuple(got) != want:
                    out["bad"].append(f"{tag}/{sub}/{name} {got} {want}")
    return out


def _merge_and_argmax(rank, world, out_dir):
    """``merge_decode_partials`` of each rank's quarter of one cache (rank
    2's quarter and all of row 1 invalid) and ``vocab_parallel_argmax`` of
    each rank's quarter of logits with ties across ranks, on this rank."""
    import torch.distributed as dist
    g = torch.Generator().manual_seed(3)
    b, S, H, K, D = 3, 64, 8, 2, 32
    q = torch.randn(b, 1, H, D, generator=g)
    k, v = torch.randn(b, S, K, D, generator=g), torch.randn(b, S, K, D,
                                                             generator=g)
    valid = torch.rand(b, S, generator=g) < 0.6
    valid[:, 2 * S // 4:3 * S // 4] = False
    valid[1] = False
    n = S // world
    mine = slice(rank * n, (rank + 1) * n)
    o, lse = gqa_decode_ref(q, k[:, mine], v[:, mine],
                            valid[:, mine].contiguous(), return_lse=True)
    o, lse = col.merge_decode_partials(o, lse, dist.group.WORLD)
    logits = torch.randint(-3, 3, (6, 4 * 5), generator=g).float()
    logits[0, 7] = logits[0, 13] = logits[0, 2] = 9.0   # ties over 2 ranks
    logits[1, 19] = logits[1, 15] = 9.0                 # both on rank 3
    tok = col.vocab_parallel_argmax(logits[:, rank * 5:(rank + 1) * 5],
                                    dist.group.WORLD, rank)
    np.savez(os.path.join(out_dir, f"merge{rank}.npz"), o=o.numpy(),
             lse=lse.numpy(), tok=tok.numpy(), q=q.numpy(), k=k.numpy(),
             v=v.numpy(), valid=valid.numpy(), logits=logits.numpy())


def _work(rank, world, out_dir):
    _merge_and_argmax(rank, world, out_dir)
    rank_out = os.path.join(out_dir, f"r{rank}")
    os.makedirs(rank_out, exist_ok=True)
    return {key: _plan(key, rank_out) for key in CASES}


def _single(dtype, out_dir=None, res=None):
    """{(key, dtype): the single-process run of the whole batch}; given the
    ranks' results, its MoE layers dispatch to the experts the ranks
    picked (``sharded_routes``)."""
    out = {}
    for key, (_, _, _, B, P, L, _) in CASES.items():
        if dtype not in DTYPES[key]:
            continue
        cfg = config(key)
        force = None if res is None else sharded_routes(out_dir, res, key,
                                                        dtype)
        out[key, dtype] = run(cfg, params_of(cfg, dtype), prompts(cfg, B, P),
                              L, dtype, force=force)
    return out


def sharded_routes(out_dir, res, key, dtype):
    """{"route{c}": the global batch's experts (B, s, k) of the c-th MoE
    call} from the ranks' ``dtype`` runs, each rank's rows where they sit
    in the batch (the model ranks of a data rank agree), or None for a
    config without MoE."""
    B = CASES[key][3]
    routes = {}
    for coords, got in _each_rank(out_dir, res, key, dtype):
        rows = rows_of(key, coords, mesh_sizes(key))
        for n in got.files:
            if not n.startswith("route"):
                continue
            whole = routes.setdefault(n, np.full((B,) + got[n].shape[1:],
                                                 -1))
            assert ((whole[rows] == -1) | (whole[rows] == got[n])).all(), \
                (key, coords, n)
            whole[rows] = got[n]
    assert all((r >= 0).all() for r in routes.values()), key
    return routes or None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(out_dir, [each rank's results], single, the JAX process's output
    or None): one spawn of 4 ranks for every plan, the JAX subprocess and
    the single-process runs beside it."""
    out_dir = tmp_path_factory.mktemp("serve")
    jax_run = start_jax_serve(out_dir, [
        {"name": key, "arch": CASES[key][0], "fields": CASES[key][1],
         "mesh": CASES[key][2], "batch": CASES[key][3],
         "cache_len": CASES[key][5], "zero_data": CASES[key][6],
         "params": params_of(config(key), "fp32"),
         "prompt": prompts(config(key), CASES[key][3], CASES[key][4])}
        for key in JAX_CASES])
    try:
        ctx = spawn_ranks(_work, WORLD, out_dir)
        single = _single("fp32")
        res = join_ranks(ctx, WORLD, out_dir)
        single.update(_single("bf16", out_dir, res))
        out, err = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0, err[-3000:]
    return out_dir, res, single


def _local(key, arr, what, coords):
    """The shard of a single-process array that the rank at ``coords``
    holds: logits by its rows (and V/t columns when the head shards the
    vocabulary), a cache leaf by its spec."""
    arch, _, _, B, _, L, _ = CASES[key]
    cfg = config(key)
    sizes = mesh_sizes(key)
    t = sizes["model"]
    if what == "logits":
        rows = rows_of(key, coords, sizes)
        out = arr[rows]
        if t > 1 and cfg.vocab_size % t == 0:
            w = cfg.vocab_size // t
            out = out[..., coords["model"] * w:(coords["model"] + 1) * w]
        return out
    if what == "tokens":
        return arr[rows_of(key, coords, sizes)]
    _, sub, name = what.split("/")
    spec = local_cache_specs(cfg, B, L, sizes)[sub][name]
    return col.shard_leaf(torch.from_numpy(arr), spec, sizes, coords).numpy()


def _each_rank(out_dir, res, key, dtype):
    for r, rank in enumerate(res):
        coords = rank[key]["coords"]
        yield coords, np.load(out_dir / f"r{r}" / f"{key}-{dtype}.npz")


def _routes_agree(key, got, want, coords, dtype):
    """The rank's MoE routing: in float32 the single process's on its rows.
    In bfloat16 the single process ran on the ranks' experts (``forced``);
    where its own top-k differs from them, its gap between the k-th and
    the next probability is under NEAR_TIE."""
    rows = rows_of(key, coords, mesh_sizes(key))
    calls = sorted(n for n in want if n.startswith("route"))
    assert sorted(n for n in got.files if n.startswith("route")) == calls
    for n in calls:
        c = n[len("route"):]
        if dtype == "fp32":
            assert np.array_equal(got[n], want[n][rows]), (coords, n)
            continue
        assert np.array_equal(got[n], want[f"forced{c}"][rows]), (coords, n)
        flip = (want[n] != want[f"forced{c}"]).any(-1)
        assert (want[f"gap{c}"][flip] < NEAR_TIE).all(), (
            coords, n, want[f"gap{c}"][flip])


IDS = list(CASES)
RUNS = [pytest.param(key, dtype, id=f"{key}-{dtype}") for key in CASES
        for dtype in DTYPES[key]]


@pytest.mark.parametrize("key,dtype", RUNS)
def test_logits_match_single_process(runs, key, dtype):
    """Every rank's logits of the prefill and each decode step: its rows
    (and V/t columns) of the single-process logits, within TOL."""
    out_dir, res, single = runs
    want = single[key, dtype]
    for coords, got in _each_rank(out_dir, res, key, dtype):
        _routes_agree(key, got, want, coords, dtype)
        for i in range(STEPS):
            ok, err = close(got[f"logits{i}"], _local(
                key, want[f"logits{i}"], "logits", coords), TOL[dtype])
            assert ok, (coords, i, err)


@pytest.mark.parametrize("key,dtype", RUNS)
def test_caches_match_single_process(runs, key, dtype):
    """Every rank's cache after the prefill and after the last decode step:
    its spec's shard of the single-process cache, within TOL."""
    out_dir, res, single = runs
    want = single[key, dtype]
    names = [n for n in want if "/" in n]
    for coords, got in _each_rank(out_dir, res, key, dtype):
        assert sorted(n for n in got.files if "/" in n) == sorted(names)
        _routes_agree(key, got, want, coords, dtype)
        for n in names:
            ok, err = close(got[n], _local(key, want[n], n, coords),
                             TOL[dtype])
            assert ok, (coords, n, err)


@pytest.mark.parametrize("key", IDS)
def test_fp32_greedy_tokens_equal(runs, key):
    """Four float32 greedy steps: every rank's tokens of its rows, from the
    steps above and from ``greedy_decode(..., par=)``, equal the
    single-process ones."""
    out_dir, res, single = runs
    want = single[key, "fp32"]["tokens"]
    for coords, got in _each_rank(out_dir, res, key, "fp32"):
        mine = _local(key, want, "tokens", coords)
        assert np.array_equal(got["tokens"], mine), coords
        assert np.array_equal(got["greedy"], mine), coords


@pytest.mark.parametrize("key", IDS)
def test_cache_shards_have_the_specs_shapes(runs, key):
    _, res, _ = runs
    for rank in res:
        assert rank[key]["bad"] == []


@pytest.mark.parametrize("key", JAX_CASES)
def test_caches_match_the_jax_sharded_serving(runs, key):
    """Each device's addressable shard of the JAX package's prefill caches
    (on ``prefill_cache_specs``) and of its decode step's (on
    ``cache_specs``), from the same float32 parameters, prompt and first
    token: the port's rank at the same mesh coordinates holds the same
    shard within 2e-5; the JAX logits, replicated, match the ranks' too."""
    out_dir, res, single = runs
    jax_out = np.load(out_dir / f"jax-{key}.npz")
    axes = list(mesh_sizes(key))
    want = single[key, "fp32"]
    assert np.array_equal(jax_out["tokens"], want["tokens"][:, :1])
    for tag, i in (("prefill", 0), ("decode", 1)):
        ok, err = close(want[f"logits{i}"], jax_out[f"logits{i}"],
                         TOL["fp32"])
        assert ok, (tag, err)
    seen = 0
    for coords, got in _each_rank(out_dir, res, key, "fp32"):
        at = str(tuple(coords[a] for a in axes))
        for n in jax_out.files:
            if not n.endswith("@" + at):
                continue
            ok, err = close(got[n.split("@")[0]], jax_out[n], TOL["fp32"])
            assert ok, (n, err)
            seen += 1
    assert seen and seen == sum(1 for n in jax_out.files if "@" in n)


def test_merge_decode_partials_is_the_whole_softmax(runs):
    """Four ranks' partial decodes over a quarter of the cache each (rank
    2's quarter invalid, row 1 invalid everywhere), merged: the whole
    cache's output and log-sum-exp within 2e-5 on every rank; the invalid
    row gives 0 and -inf exactly."""
    out_dir = runs[0]
    for r in range(WORLD):
        got = np.load(out_dir / f"merge{r}.npz")
        q, k, v, valid = (torch.from_numpy(got[n]) for n in
                          ("q", "k", "v", "valid"))
        o, lse = gqa_decode_ref(q, k, v, valid, return_lse=True)
        live = valid.any(dim=1).numpy()
        np.testing.assert_allclose(got["o"][live], o.numpy()[live],
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["lse"][live], lse.numpy()[live],
                                   atol=1e-5, rtol=0)
        assert (got["o"][~live] == 0).all()
        assert (got["lse"][~live] == -np.inf).all()


def test_vocab_parallel_argmax_is_torch_argmax(runs):
    """Greedy tokens from four ranks' V/4 columns: ``torch.argmax`` of the
    whole row on every rank, ties across ranks and inside one rank going
    to the lowest global index."""
    out_dir = runs[0]
    for r in range(WORLD):
        got = np.load(out_dir / f"merge{r}.npz")
        want = torch.argmax(torch.from_numpy(got["logits"]), dim=-1).numpy()
        assert np.array_equal(got["tok"], want)
        assert got["tok"][0] == 2 and got["tok"][1] == 15


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_lse_is_the_whole_softmax(dtype):
    """``gqa_decode_ref`` and ``gqa_decode_splitk`` with ``return_lse``:
    the float32 output of the whole-cache softmax and its log-sum-exp
    (``torch.logsumexp`` of the masked float32 scores); a row with no
    valid slot gives 0 and -inf exactly."""
    g = torch.Generator().manual_seed(4)
    b, S, H, K, D = 3, 96, 8, 2, 32
    q = torch.randn(b, 1, H, D, generator=g).to(dtype)
    k = torch.randn(b, S, K, D, generator=g).to(dtype)
    v = torch.randn(b, S, K, D, generator=g).to(dtype)
    valid = torch.rand(b, S, generator=g) < 0.5
    valid[2] = False
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    scores = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, K, H // K, D),
                          k).float() / math.sqrt(D)
    scores = scores.masked_fill(~valid[:, None, None], -math.inf)
    p = torch.softmax(scores[:2], dim=-1)
    want_o = torch.einsum("bkgs,bskd->bkgd", p, v[:2].float()).reshape(
        2, 1, H, D)
    want_lse = torch.logsumexp(scores[:2], dim=-1).reshape(2, H)
    for o, lse in (gqa_decode_ref(q, k, v, valid, return_lse=True),
                   gqa_decode_splitk(q, k, v, valid, block_s=32,
                                     return_lse=True)):
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        assert (o[:2] - want_o).abs().max() <= tol * want_o.abs().max()
        assert (lse[:2] - want_lse).abs().max() <= (
            1e-5 if dtype == torch.float32 else 2e-2)
        assert (o[2] == 0).all() and (lse[2] == -math.inf).all()
    # without the flag, the output is what it was: v's dtype
    assert gqa_decode_ref(q, k, v, valid).dtype == dtype
