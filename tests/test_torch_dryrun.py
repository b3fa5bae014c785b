"""The dry run's parts (``repro_torch.launch.dryrun``): the kernels' stand-ins
on the meta device (``kernels.meta``), the op analysis
(``launch.op_analysis``) and its FLOPs, collectives and peak.

* Each stand-in allocates what its wrapper allocates on the card -- the
  outputs, the split-KV partials, the SSD scratch -- and nothing else (no
  (b, H, s, s) scores, no Adam temporaries), launches nothing and never
  builds; its autograd op saves the tensors it saves on the card.  Its
  FLOP formula equals ``FlopCounterMode``'s count of the plain version on
  CPU tensors at the same shapes, forward and (autograd of the plain
  version) backward.
* One train step of a smoke config on one device: the dry run's FLOPs
  against the JAX package's ``hlo_analysis`` of the same step compiled on
  the CPU.  llama3.2-3b and gpt2-350m agree exactly; mamba2-130m's differ
  by 0.8%, inside the 2% held, in one term: the SSD scan's backward (the
  forwards agree; autograd of the plain PyTorch scan counts two products
  for each of its forward's, XLA's autodiff of the JAX scan about 0.9 of
  its forward).
* A (2, 2) smoke plan: the collectives the dry run counts on meta under
  the fake process group equal those of the same step on 4 ``gloo``
  ranks (one spawn for every case), each kind's bytes and count.
* The peak: equal to ``MemTracker``'s with the 512-byte rounding off; a
  step of n microbatches extrapolated from a trace of 2 equals the step
  traced whole, FLOPs, bytes, collectives and peak.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.core import memory_model as mm
from repro_torch.kernels import LAUNCHES, _build, dispatch
from repro_torch.kernels import meta as km
from repro_torch.kernels.adam_update import adam_ref
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_decode import gqa_decode_ref, mla_decode_ref
from repro_torch.kernels.rms_norm import rms_norm_ref
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import bwd_scratch
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis
from repro_torch.launch.memcheck import fake_world
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.parallel import collectives as col
from repro_torch.train.train_loop import build_train_step, make_local_state

import test_torch_multirank_harness as H

ROOT = Path(__file__).resolve().parents[1]
F32, BF16 = torch.float32, torch.bfloat16
_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.new_empty.default, torch.ops.aten.empty_strided.default,
          torch.ops.aten.zeros_like.default, torch.ops.aten.zeros.default}


class _Allocs(TorchDispatchMode):
    """Every tensor an op makes, (shape, dtype), and every op's device."""

    def __init__(self):
        super().__init__()
        self.made, self.devices = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
                if func in _ALLOC:
                    self.made.append((tuple(t.shape), t.dtype))
        return out


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the CPU ops here are small, and a pool
    of spinning threads per test process only crowds the other processes
    of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_build(monkeypatch):
    """A meta call never builds or loads a kernel, nor counts a launch."""
    def refuse(*a, **k):
        raise AssertionError("a meta call reached the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = dict(LAUNCHES)
    yield
    assert LAUNCHES == before


def _meta(*shape, dtype=F32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _cpu(gen, *shape, dtype=F32, grad=False):
    return torch.randn(shape, generator=gen).to(dtype).requires_grad_(grad)


def _flops(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kw)
    return fc.get_total_flops(), out


def _saved(fn):
    """What autograd saves while fn runs: (shape, dtype) each."""
    seen = []

    def pack(t):
        seen.append((tuple(t.shape), t.dtype))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return seen, out


# (b, sq, sk, H, K, D, causal, window, q_offset, dtype)
ATTENTION = [(2, 64, 64, 4, 2, 32, True, 0, 0, BF16),
             (1, 48, 96, 4, 4, 64, True, 16, 48, F32),
             (2, 32, 32, 2, 1, 64, False, 0, 0, F32),
             (1, 40, 40, 6, 2, 128, True, 24, 0, BF16)]


@pytest.mark.parametrize("case", ATTENTION, ids=str)
def test_attention_stand_in(case):
    b, sq, sk, H, K, D, causal, window, off, dt = case
    kw = dict(causal=causal, window=window, q_offset=off)
    q, k, v = (_meta(b, sq, H, D, dtype=dt, grad=True),
               _meta(b, sk, K, D, dtype=dt, grad=True),
               _meta(b, sk, K, D, dtype=dt, grad=True))
    tally = []
    km.TALLY = lambda *a: tally.append(a)
    try:
        with _Allocs() as al:
            saved, o = _saved(lambda: dispatch.attention(q, k, v, **kw))
        # forward: o and the log-sum-exp, both saved with q, k, v
        assert al.made == [((b, sq, H, D), dt), ((b, H, sq), F32)]
        assert saved == [(tuple(q.shape), dt), (tuple(k.shape), dt),
                         (tuple(v.shape), dt), ((b, sq, H, D), dt),
                         ((b, H, sq), F32)]
        with _Allocs() as al:
            o.backward(torch.empty_like(o))
        assert ((b, H, sq), F32) in al.made          # D_i, the kernel's
        assert al.devices == {"meta"}
        assert (q.grad.shape, k.grad.shape, v.grad.shape) == (
            q.shape, k.shape, v.shape)
        assert [t[0] for t in tally] == ["flash_attention",
                                         "flash_attention_bwd"]
    finally:
        km.TALLY = None
    gen = torch.Generator().manual_seed(0)
    cq, ck, cv = (_cpu(gen, b, sq, H, D, dtype=dt, grad=True),
                  _cpu(gen, b, sk, K, D, dtype=dt, grad=True),
                  _cpu(gen, b, sk, K, D, dtype=dt, grad=True))
    fwd, out = _flops(attention_ref, cq, ck, cv, **kw)
    bwd, _ = _flops(out.backward, torch.ones_like(out))
    assert fwd == km.attention_flops(b, sq, sk, H, D) == tally[0][1]
    assert bwd == km.attention_bwd_flops(b, sq, sk, H, D) == tally[1][1]
    # each operand and output once: q, k, v, o and the log-sum-exp
    nbytes = [t.numel() * t.element_size() for t in (q, k, v)]
    assert tally[0][2] == sum(nbytes) + nbytes[0] + b * H * sq * 4


# (b, S, H, K, D, return_lse, dtype)
DECODE = [(2, 200, 4, 2, 32, False, BF16), (1, 1000, 8, 2, 64, True, F32),
          (3, 64, 6, 3, 128, True, BF16), (8, 32_768, 24, 8, 128, False, BF16)]


@pytest.mark.parametrize("case", DECODE, ids=str)
def test_gqa_decode_stand_in(case):
    b, S, H, K, D, lse, dt = case
    G = H // K
    q = _meta(b, 1, H, D, dtype=dt)
    kc, vc = _meta(b, S, K, D, dtype=dt), _meta(b, S, K, D, dtype=dt)
    valid = _meta(b, S, dtype=torch.bool)
    with _Allocs() as al:
        out = dispatch.flash_decode(q, kc, vc, valid, return_lse=lse)
    ns = -(-S // km.gqa_block_s(b, S, K))
    want = [((b, ns, K, G, D), F32), ((b, ns, K, G), F32),
            ((b, ns, K, G), F32), ((b, 1, H, D), F32 if lse else dt)]
    assert al.made == want + ([((b, H), F32)] if lse else [])
    outs = out if lse else (out,)
    assert [tuple(t.shape) for t in outs] == [(b, 1, H, D), (b, H)][:len(outs)]
    if S > 1000:
        return                      # the card's shape: allocation only
    gen = torch.Generator().manual_seed(1)
    cvalid = torch.rand((b, S), generator=gen) < 0.8
    fl, _ = _flops(gqa_decode_ref, _cpu(gen, b, 1, H, D, dtype=dt),
                   _cpu(gen, b, S, K, D, dtype=dt),
                   _cpu(gen, b, S, K, D, dtype=dt), cvalid, return_lse=lse)
    assert fl == km.gqa_decode_flops(b, S, H, D)


# (b, S, H, r, dr, dtype): fused in a cluster, or merged from partials
MLA = [(2, 100, 4, 32, 16, BF16), (1, 1500, 8, 512, 64, BF16),
       (2, 300, 4, 32, 16, F32), (8, 32_768, 8, 512, 64, BF16)]


@pytest.mark.parametrize("case", MLA, ids=str)
def test_mla_decode_stand_in(case):
    b, S, H, r, dr, dt = case
    args = (_meta(b, H, r, dtype=dt), _meta(b, H, dr, dtype=dt),
            _meta(b, S, r, dtype=dt), _meta(b, S, dr, dtype=dt),
            _meta(b, S, dtype=torch.bool))
    with _Allocs() as al:
        out = dispatch.mla_flash_decode(*args, denom=(dr + 128) ** 0.5)
    _, (ns, _, _), fused = km.mla_plan(b, S, H, dt == BF16)
    n = 0 if fused else b * ns * H
    assert al.made == [((n * r,), F32), ((n,), F32), ((n,), F32),
                       ((b, H, r), dt)]
    assert tuple(out.shape) == (b, H, r)
    if S > 2000:
        return
    gen = torch.Generator().manual_seed(2)
    fl, _ = _flops(mla_decode_ref, _cpu(gen, b, H, r, dtype=dt),
                   _cpu(gen, b, H, dr, dtype=dt), _cpu(gen, b, S, r, dtype=dt),
                   _cpu(gen, b, S, dr, dtype=dt),
                   torch.rand((b, S), generator=gen) < 0.9,
                   denom=(dr + 128) ** 0.5)
    assert fl == km.mla_decode_flops(b, S, H, r, dr)


# (b, s, h, p, n, dtype)
SSD = [(2, 128, 3, 32, 16, F32), (1, 200, 4, 32, 16, BF16),
       (2, 64, 2, 64, 128, BF16), (1, 1000, 5, 32, 16, F32)]


def _ssd_inputs(make, b, s, h, p, n, dt, grad):
    return (make(b, s, h, p, dtype=dt, grad=grad),
            make(b, s, h, dtype=dt, grad=grad), make(h, grad=grad),
            make(b, s, n, dtype=dt, grad=grad),
            make(b, s, n, dtype=dt, grad=grad), make(h, grad=grad),
            make(h, grad=grad))


@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_stand_in(case):
    b, s, h, p, n, dt = case
    args = _ssd_inputs(_meta, b, s, h, p, n, dt, True)
    with _Allocs() as al:
        saved, (y, state) = _saved(lambda: dispatch.ssd(*args))
    want = [((b, s, h, p), dt), ((b, h, p, n), F32)]
    if dt == BF16:
        L = km.SSD_CHUNK
        nc = -(-s // L)
        nseg = -(-nc // km.ssd_segment_chunks(b, s, h))
        want += [((b, nc, L, L), F32), ((b, nseg - 1, h, p, n), F32),
                 ((b, nseg - 1, h), F32)]
    assert al.made == want
    assert saved == [(tuple(t.shape), t.dtype) for t in args]
    with _Allocs() as al:
        y.backward(torch.empty_like(y))
    scratch = [(shape, F32) for shape in bwd_scratch(
        b, s, h, p, n, dt, km.SSD_BWD_CHUNK).values()]
    assert all(x in al.made for x in scratch)
    assert al.devices == {"meta"}
    assert [tuple(t.grad.shape) for t in args] == [tuple(t.shape)
                                                   for t in args]
    gen = torch.Generator().manual_seed(3)
    cargs = _ssd_inputs(lambda *sh, dtype=F32, grad=False: _cpu(
        gen, *sh, dtype=dtype, grad=grad), b, s, h, p, n, dt, True)
    fwd, (cy, cstate) = _flops(ssd_scan_ref, *cargs)
    assert fwd == km.ssd_flops(b, s, h, p, n)
    bwd, _ = _flops((cy.float().sum() + cstate.sum()).backward)
    assert bwd == km.ssd_bwd_flops(b, s, h, p, n)


def test_rms_norm_and_adam_stand_ins():
    """RMSNorm allocates its output and row scales; Adam, in place, nothing.
    Neither has a product for ``FlopCounterMode`` to count."""
    x, scale = _meta(4, 7, 64, dtype=BF16), _meta(64)
    with _Allocs() as al:
        y = dispatch.rms_norm(x, scale)
    assert al.made == [((4, 7, 64), BF16), ((4, 7), F32)]
    assert y.shape == x.shape
    leaf = [_meta(3, 8) for _ in range(4)] + [_meta(3, 8, dtype=BF16)]
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1, c1=0.1,
              c2=0.05)
    with _Allocs() as al:
        dispatch.adam_update_leaf(*leaf, **kw)
    assert al.made == []
    gen = torch.Generator().manual_seed(4)
    assert _flops(rms_norm_ref, _cpu(gen, 4, 64), _cpu(gen, 64))[0] == 0
    assert _flops(adam_ref, *(_cpu(gen, 3, 8) for _ in range(4)),
                  **kw)[0] == 0


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor still gets the plain version: nothing builds, and the
    scores it holds are the plain version's."""
    gen = torch.Generator().manual_seed(5)
    q = _cpu(gen, 1, 16, 2, 32)
    with _Allocs() as al:
        o = dispatch.attention(q, q, q)
    assert torch.allclose(o, attention_ref(q, q, q))
    assert al.devices == {"cpu"}


# ------------------------------------------------ the step against JAX --

JAX_FLOPS = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.launch import hlo_analysis
from repro.models import init_params
from repro.train import build_train_step, init_opt_state
B, S, MB = map(int, sys.argv[2:5])
auto = getattr(jax.sharding, "AxisType", None)
kw = {} if auto is None else {"axis_types": (auto.Auto,) * 2}
mesh = jax.make_mesh((1, 1), ("data", "model"), **kw)
out = {}
for arch in sys.argv[1].split(","):
    cfg = smoke_config(arch)
    tc = TrainConfig(global_batch=B, seq_len=S, microbatch=MB, zero=1)
    # shapes only: the compiled step does not depend on the values
    params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    state = {"params": params, "opt": jax.eval_shape(init_opt_state, params),
             "step": jax.ShapeDtypeStruct((), jnp.int32)}
    step, n = build_train_step(cfg, tc, mesh, B, S)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S - cfg.num_modal_tokens),
                                            jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    text = jax.jit(step).lower(state, batch).compile().as_text()
    out[arch] = {"flops": hlo_analysis.analyze(text).flops, "n_micro": n}
print(json.dumps(out))
"""
FLOP_ARCHS = ("llama3.2-3b", "gpt2-350m", "mamba2-130m")
FB, FS, FMB = 4, 64, 2


@pytest.fixture(scope="module")
def jax_flops():
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_FLOPS,
                          ",".join(FLOP_ARCHS), str(FB), str(FS), str(FMB)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_step_flops_match_jax_hlo_analysis(jax_flops, arch):
    tc = TrainConfig(global_batch=FB, seq_len=FS, microbatch=FMB, zero=1)
    stats, row = dryrun.trace_train(smoke_config(arch), tc, 1, 1, 1)
    want = jax_flops[arch]
    assert row["n_micro"] == want["n_micro"]
    assert stats.flops > 0
    assert abs(stats.flops / want["flops"] - 1) <= 0.02
    if arch != "mamba2-130m":
        assert stats.flops == want["flops"]


# --------------------------------------- collectives against gloo ranks --

# (arch, zero): the dense family at each ZeRO level, MoE, Mamba2, tied and
# untied heads
COLL_CASES = [("llama3.2-3b", 0), ("llama3.2-3b", 1), ("llama3.2-3b", 3),
              ("mixtral-8x22b", 1), ("mamba2-130m", 3), ("gpt2-350m", 1)]
CB, CS = 8, 64


def _coll_tc(zero):
    return TrainConfig(global_batch=CB, seq_len=CS, microbatch=1, zero=zero)


def _gloo_collectives(rank, world, out_dir):
    from repro_torch.data import SyntheticTokens
    res = []
    for arch, zero in COLL_CASES:
        cfg = smoke_config(arch)
        tc = _coll_tc(zero)
        mesh = make_plan_mesh(2, 2, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="cpu")
        step, _ = build_train_step(cfg, tc, CB, CS, mesh=mesh)
        raw = next(SyntheticTokens(cfg, CB, CS, seed=3))
        data = {k: torch.from_numpy(raw[k]) for k in ("tokens", "labels")}
        seen = {}

        def tally(kind, nbytes):
            b, c = seen.get(kind, (0, 0))
            seen[kind] = (b + nbytes, c + 1)
        col.TALLY = tally
        try:
            step(state, data)
        finally:
            col.TALLY = None
        res.append(seen)
    return res


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_gloo")
    ctx = H.spawn_ranks(_gloo_collectives, 4, out)
    return H.join_ranks(ctx, 4, out)


@pytest.mark.parametrize("i", range(len(COLL_CASES)),
                         ids=[f"{a}-zero{z}" for a, z in COLL_CASES])
def test_collectives_on_meta_equal_gloo_ranks(gloo_ranks, i):
    arch, zero = COLL_CASES[i]
    stats, row = dryrun.trace_train(smoke_config(arch), _coll_tc(zero), 1,
                                    2, 2)
    assert row["n_micro"] == 4            # traced as 2, extrapolated
    got = {k: (stats.collective_bytes[k], stats.collective_counts[k])
           for k in stats.collective_bytes}
    for rank in range(4):
        assert got == {k: tuple(v) for k, v in gloo_ranks[rank][i].items()}
    # ZeRO >= 1 reduce-scatters the gradients over data; 0 all-reduces
    assert "all-reduce" in got and ("reduce-scatter" in got) == (zero >= 1)


# ----------------------------------------------------------- the peak --

def _smoke_step(zero=1, micro=2):
    cfg = smoke_config("llama3.2-3b")
    tc = TrainConfig(global_batch=4, seq_len=64, microbatch=micro, zero=zero)
    return cfg, tc


def test_peak_equals_memtracker_unrounded(monkeypatch):
    """``MemTracker`` follows the meta storages, unrounded: with the
    512-byte rounding off the dry run's peak is its peak exactly, and the
    rounding only raises it."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg, tc = _smoke_step()
    with fake_world(1):
        mesh = make_plan_mesh(1, 1, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="meta",
                                 whole_leaves=False)
        step, _ = build_train_step(cfg, tc, 4, 64, mesh=mesh)
        data = dryrun.train_batch(cfg, 4, 64)
        mt = MemTracker()
        mt.track_external(*tree_flatten((state["params"], state["opt"]))[0],
                          *data.values())
        with mt:
            step(state, data)
        theirs = mt.get_tracker_snapshot("peak")[torch.device("meta")]
        with op_analysis.Analysis(live=(state, data)) as rounded:
            step(state, data)
        monkeypatch.setattr(op_analysis, "ALLOC_ROUND", 1)
        with op_analysis.Analysis(live=(state, data)) as exact:
            step(state, data)
    assert mm.dryrun_peak_bytes(exact) == theirs["Total"]
    assert mm.dryrun_peak_bytes(rounded) >= mm.dryrun_peak_bytes(exact)


def _check_extrapolation(cfg, tc, d, t, n_micro):
    ext, row = dryrun.trace_train(cfg, tc, 1, d, t)
    whole, _ = dryrun.trace_train(cfg, tc, 1, d, t, every_micro=True)
    assert row["n_micro"] == n_micro
    assert ext.to_json() == whole.to_json()
    assert ext.kernel_calls == whole.kernel_calls
    assert (ext.entry_bytes, ext.temp_bytes) == (whole.entry_bytes,
                                                  whole.temp_bytes)


def test_microbatch_extrapolation_equals_the_whole_step():
    """A step of 4 microbatches on (2, 2) traced as 2 and extrapolated
    equals the same step traced whole."""
    _check_extrapolation(smoke_config("llama3.2-3b"), _coll_tc(1), 2, 2, 4)


def test_microbatch_extrapolation_on_one_device():
    """The same on one device, whose step accumulates without the sharded
    step's collectives (the card rows' (1, 1) plans): 5 microbatches."""
    tc = TrainConfig(global_batch=5, seq_len=CS, microbatch=1, zero=1)
    _check_extrapolation(smoke_config("gpt2-350m"), tc, 1, 1, 5)


def _flop_counter_step(cfg, tc, pods, d, t):
    """The same step's FLOPs by ``FlopCounterMode`` itself plus the
    stand-ins' tally, with no analysis open."""
    kernel = []
    with fake_world(pods * d * t):
        mesh = make_plan_mesh(d, t, device_type="cpu", pods=pods)
        state = make_local_state(cfg, tc, mesh, device="meta",
                                 whole_leaves=False)
        step, _ = build_train_step(cfg, tc, tc.global_batch, tc.seq_len,
                                   mesh=mesh)
        data = dryrun.train_batch(cfg, tc.global_batch, tc.seq_len)
        km.TALLY = lambda op, flops, nbytes: kernel.append(flops)
        try:
            with FlopCounterMode(display=False) as fc:
                step(state, data)
        finally:
            km.TALLY = None
    return fc.get_total_flops() + sum(kernel)


@pytest.mark.parametrize("arch,zero", [("llama3.2-3b", 1), ("mixtral-8x22b", 3),
                                       ("mamba2-130m", 1)])
def test_analysis_counts_what_flop_counter_mode_counts(arch, zero,
                                                       monkeypatch):
    """One dispatch mode counts the FLOPs ``FlopCounterMode`` counts; its
    cache of pure ops' output metadata changes no count and no peak, over
    a step of two microbatches (the second one's ops all hit the cache)."""
    cfg = smoke_config(arch)
    tc = TrainConfig(global_batch=4, seq_len=64, microbatch=1, zero=zero)
    cached, row = dryrun.trace_train(cfg, tc, 1, 2, 2)
    assert row["n_micro"] == 2
    assert cached.flops == _flop_counter_step(cfg, tc, 1, 2, 2)
    monkeypatch.setattr(op_analysis, "_pure", lambda func: False)
    plain, _ = dryrun.trace_train(cfg, tc, 1, 2, 2)
    assert cached == plain


def test_analysis_closes_its_tallies():
    a, b = torch.empty((4, 4), device="meta"), torch.empty((4, 4),
                                                            device="meta")
    with op_analysis.Analysis(live=[a, b]) as stats:
        a @ b
    assert col.TALLY is None and km.TALLY is None
    assert stats.flops == 2 * 4 * 4 * 4
    assert stats.hbm_bytes == 3 * 64
    # 64-byte blocks count 512 each, as the caching allocator's do
    assert (stats.entry_bytes, stats.temp_bytes) == (1024, 512)
    assert mm.dryrun_peak_bytes(stats) == 1536


def test_cached_op_that_aliases_its_input_stays_an_alias():
    """``_unsafe_view`` marks no alias in its schema but returns its
    input's storage: the metadata cache runs it again, so a repeat holds
    no new storage, and it moves no bytes."""
    x = torch.empty((64, 64), device="meta")
    with op_analysis.Analysis(live=[x]) as stats:
        for _ in range(3):
            y = torch.ops.aten._unsafe_view(x, (4096,))
            assert y.untyped_storage()._cdata == x.untyped_storage()._cdata
    assert (stats.entry_bytes, stats.temp_bytes) == (16384, 0)
    assert stats.hbm_bytes == 0


def test_cli_writes_one_row_per_combo(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--both-meshes", "--out",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for mesh in ("16x16", "2x16x16"):
        row = json.loads((tmp_path / f"mamba2-130m__decode_32k__{mesh}.json")
                         .read_text())
        assert not row["ok"] and "queue 1 item 10" in row["refused"]
