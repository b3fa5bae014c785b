#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths (llama3.2-3b, deepseek-v2-236b,
mamba2-130m) and its training path (gpt2-350m) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   hand-written kernels from ``src/repro_torch/kernels/csrc``: each
   kernel's registers, spills and static shared memory from the ptxas log
   and its tensor-core instructions from ``cuobjdump -sass`` (every bf16
   attention body at every head dim must have some, and the gradient
   kernels no atomics);
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it and at edge cases (window, GQA, sq != sk,
   float32, ragged tails, a fully masked cache block, an all-invalid row,
   the MLA decode at deepseek-v2's widths and at its smoke config's, the
   forward attention at the MLA head dims 192 and 48, the SSD scan at
   mamba2-130m's prefill, at a 32k prompt, at a ragged length, in float32
   and at its smoke widths), the attention backward also against autograd
   through the plain forward and run twice for bit-identical gradients,
   with its time, the plain version's, one PyTorch library call's (none
   computes the SSD scan) and the card's bound for the same work;
3. llama3.2-3b at full width in bfloat16 with random weights from a seed:
   (a) batch prefill + greedy decode -- the serving path, run with the
   launch counts set to 0 just before and read just after, then a
   torch.profiler trace of one prefill and one decode step for the
   device's busy time and idle share and the largest kernels; (b) its
   logits against the same path on the plain versions; (c) 16 requests
   through the continuous and the disaggregated batchers, against
   per-request greedy decoding, and one decode step alone against the same
   step as a row of a batch of 8;
4. deepseek-v2-236b at its published widths and 4 of its 60 layers (all
   60 do not fit one card), bf16 weights with a float32 router, random
   from a seed: the same (a) serving run and trace, through MLA prefill
   (flash attention at head dim 192) and the absorbed MLA decode kernel;
   (b) layer 0's MLA output, prefill and first decode step, against the
   plain versions, then the whole model's logits and the share of routing
   choices the two paths agree on; (c) the two batchers;
5. mamba2-130m at full width and depth (24 Mamba2 layers, d_model 768,
   24 SSD heads of 64, state 128), bf16 with float32 A_log/D/dt_bias,
   random from a seed: the same (a) serving run and trace, through the
   ``ssd_scan`` kernel once a layer a prefill (the decode step is plain
   PyTorch, as in the JAX package); (a') one timed prefill of one 32,768-
   token prompt; (b) layer 0's mixer output and final SSD state, then the
   whole model's prefill and first decode logits, against the plain path;
   (c) the two batchers;
6. gpt2-350m at full width (24 layers, bf16 params, fp32 Adam state) --
   the training path, ``repro_torch.launch.train.train`` with global batch
   8, sequence 1024, microbatch 1 and block remat, 1 warm-up + 12 timed
   steps with the launch counts set to 0 just before and read just after:
   step time, tokens/s, MFU, peak device memory over step 1, the loss
   falling; a torch.profiler trace of one step; one microbatch's loss and
   grad norm against the plain versions.

Each phase prints its wall time.  Then one JSON line of per-kernel
numbers and, last, the JSON result line.
Any failed check raises and the script exits non-zero.  Without a CUDA
card, or without the repository around it, it exits non-zero and prints
no result.
"""
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# (bytes/s, bf16 dense FLOP/s, fp32 non-tensor FLOP/s) from NVIDIA's data
# sheets, by nvidia-smi name
PEAKS = {"H100 80GB HBM3": (3.35e12, 989e12, 67e12),     # SXM5
         "H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12)}
BF16_TOL, FP32_TOL = 2e-2, 2e-5
# The attention backward against its plain versions: max|d| <= tol *
# max|ref| per gradient, tol as the forward's -- bf16: both round their
# float32 sums to bf16 once (2^-8 relative steps), and the kernel's D_i is
# rowsum(dO O) from the bf16 output where autograd's is exact; fp32: the
# sums run in other orders.
# Adam against its plain version: the JAX package's kernel tolerance.
ADAM_ATOL, ADAM_RTOL = 1e-6, 1e-5
# Training kernel path against the plain path over one full-width
# microbatch: the forward kernel rounds p to bf16 before PV where the plain
# version keeps float32, and 24 layers carry those one-step bf16
# differences into the loss (a mean over 1023 tokens, which averages them)
# and into every gradient (the grad norm is dominated by the largest).  A
# wrong mask, head mapping or gradient term moves either by its own scale.
LOSS_RTOL, GNORM_RTOL = 1e-2, 5e-2
# The JAX package's exact_peak_bytes(gpt2-350m, 8, 1024, d=1, t=1, zero=1,
# microbatch=1) for the training cell, printed beside the card's peak.
JAX_PREDICTED_PEAK = 8_691_153_715
# Kernel path vs plain path, max |logit delta| / max |logit|, bf16 at full
# width: the two paths round attention differently (p to bf16 before PV in
# the kernels, float32 throughout in the plain versions; bf16 steps are
# 2^-8 = 3.9e-3 relative) and 28 residual layers carry such one-step
# differences to the logits.  A wrong mask, head mapping or merge moves
# the logits by the order of their own scale.
LOGITS_TOL = 5e-2

# deepseek-v2 kernel path vs plain path, max |logit delta|, absolute: the
# two paths round attention differently (as for llama above), and a bf16
# difference in a router's input can flip a near-tied top-6 choice, which
# swaps one expert's whole output for a token.  The JAX package's own
# MoE/MLA check loosens to the same atol 0.8 for this reason
# (tests/test_models.py:38-43).  Layer 0's MLA output has no routing in
# front of it and is held at the kernels' own 2e-2 of max |ref|.
DEEPSEEK_LOGITS_ATOL = 0.8
DEEPSEEK_LAYERS = 4

# The SSD scan against its plain version, elementwise |d| <= tol + tol |ref|
# on y and on the final state: the JAX package's own SSD kernel tolerances
# (tests/test_kernels.py:57).  The kernel walks 64-row chunks and the plain
# version 128-row ones, which is exact in math, so they differ by float32
# sums in other orders and, in bf16, by y rounded once on each side.
SSD_BF16_TOL, SSD_FP32_TOL = 5e-2, 2e-3
# mamba2-130m kernel path vs plain path, max |d| / max |ref|: layer 0's
# mixer output and final state, and the whole model's logits.  The two
# paths chunk the scan differently and round y to bf16 on different sums;
# 24 residual layers carry such one-step differences to the logits.  A
# wrong decay, mask or state carry moves them by their own scale.
MAMBA2_TOL = 5e-2

# The attention kernels' bf16 bodies, which must run on the tensor cores:
# by source, the kernel names and the head dims each is instantiated for.
MMA_KERNELS = {"flash_attention": (("flash_attention_mma",), (32, 48, 64, 128, 192)),
               "flash_attention_bwd": (("bwd_dkdv_mma", "bwd_dq_mma"), (32, 64, 128))}

SPIN_CYCLES = 2_000_000    # ~1 ms at the H100's ~2 GHz: covers a call's host work

PREFILL = dict(b=8, s=512, H=24, K=8, D=128)
DECODE = dict(b=8, S=544, H=24, K=8, D=128)
# deepseek-v2's MLA at b=8, prompt 512 + 32 new tokens: prefill attention at
# qk head dim dn + dr = 192 (H = K = 128), decode over latent width r = 512
# and rope width dr = 64
MLA_PREFILL = dict(b=8, s=512, H=128, D=192)
MLA_DECODE = dict(b=8, S=544, H=128, r=512, dr=64)
# mamba2-130m's SSD scan at b=8, prompt 512 (24 heads of P=64, state N=128),
# and at one 32,768-token prompt, the JAX package's prefill_32k length
SSD_PREFILL = dict(b=8, s=512, h=24, P=64, N=128)
SSD_LONG = dict(b=1, s=32_768, h=24, P=64, N=128)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def demangle(mangled):
    """``name<args>`` of a kernel from its mangled name: the last
    length-prefixed component of the nested name and its template
    arguments (integers, float, named types)."""
    s = re.sub(r"^_ZN?", "", mangled)
    parts = []
    while (m := re.match(r"\d+", s)):
        n = int(m.group())
        parts.append(s[m.end():m.end() + n])
        s = s[m.end() + n:]
    if not parts:
        return mangled
    args = []
    if s.startswith("I"):
        s = s[1:]
        while s and s[0] != "E":
            if (m := re.match(r"Li(-?\d+)E", s)):
                args.append(m.group(1))
            elif (m := re.match("f", s)):
                args.append("float")
            elif (m := re.match(r"\d+", s)):
                n = int(m.group())
                args.append(s[m.end():m.end() + n])
                s = s[m.end() + n:]
                continue
            else:
                break
            s = s[m.end():]
    return f"{parts[-1]}<{', '.join(args)}>" if args else parts[-1]


def ptxas_report(log):
    """{mangled kernel: dict of registers, stack, spill bytes and static
    shared memory} from a ``ptxas -v`` log."""
    out, cur, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        if (m := re.search(r"Compiling entry function '([^']+)'", line)):
            cur = m.group(1)
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                             r" (\d+) bytes spill loads", line)):
            frame = tuple(int(x) for x in m.groups())
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur] = dict(registers=int(m.group(1)), stack=frame[0],
                            spill_stores=frame[1], spill_loads=frame[2],
                            static_smem=int(smem.group(1)) if smem else 0)
            cur, frame = None, (0, 0, 0)
    return out


def sass_opcodes(lib):
    """{mangled kernel: Counter of SASS opcodes (HMMA, ATOMG, ...)} from
    ``cuobjdump -sass`` of a built library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if (m := re.search(r"Function : (\S+)", line)):
            cur = out.setdefault(m.group(1), Counter())
        elif cur is not None and (m := re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)", line)):
            cur[m.group(1)] += 1
    return out


def report_build():
    """Per kernel of every source: registers, spills and static shared
    memory from the ptxas log (dynamic shared memory is set at launch),
    and tensor-core instructions from the SASS.  Fails unless every bf16
    attention body at every head dim has HMMA (or HGMMA) instructions and
    the gradient kernels have no atomics."""
    from repro_torch.kernels import _build
    for src in _build.sources():
        lib = _build.library(src)
        report = ptxas_report(lib.with_suffix(".log").read_text())
        sass = sass_opcodes(lib)
        for mangled in sorted(report, key=demangle):
            r, ops = report[mangled], sass.get(mangled, Counter())
            print(f"build {src}: {demangle(mangled)}: {r['registers']} registers,"
                  f" {r['spill_stores']} B spill stores, {r['spill_loads']} B"
                  f" spill loads, {r['stack']} B stack, {r['static_smem']} B"
                  f" static smem, {ops['HMMA'] + ops['HGMMA']} HMMA/HGMMA")
        if src == "flash_attention_bwd":
            # ATOM* and RED are memory atomics; REDUX is a warp reduction
            atomics = sum(c for ops in sass.values() for op, c in ops.items()
                          if op.startswith("ATOM") or op == "RED")
            print(f"sass {src}: {atomics} atomic instructions"
                  f" {'ok' if atomics == 0 else 'FAIL'}")
            check(atomics == 0, "the attention backward uses atomics")
        if src not in MMA_KERNELS:
            continue
        names, dims = MMA_KERNELS[src]
        labels = Counter()
        for mangled, ops in sass.items():
            labels[demangle(mangled)] += ops["HMMA"] + ops["HGMMA"]
        for name in names:
            for D in dims:
                n = sum(c for label, c in labels.items()
                        if label.startswith(f"{name}<{D}>") or
                        label.startswith(f"{name}<{D},"))
                print(f"sass {src}: {name} D={D} bf16: {n} HMMA/HGMMA"
                      f" {'ok' if n > 0 else 'FAIL'}")
                check(n > 0, f"{name} at D={D} has no tensor-core instruction")


def time_ms(fn, flush, iters=20):
    """Mean device time of fn() over iters launches, each after an L2 flush
    (the serving path finds its attention inputs cold: the weights of a
    layer stream through the cache between two attention calls).  A spin
    kernel after the flush keeps the card busy while the host issues fn(),
    so the events time the device's work and not the host's."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def device_profile(fn, n):
    """Device time per call of fn() over n calls, from a torch.profiler
    trace: (busy ms, [(kernel name, ms)] largest first, device events per
    call).  Busy is the sum of the device events' durations; the path runs
    on one stream, so they do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n)
                      for e in events), key=lambda r: -r[1])
    return (sum(ms for _, ms in kernels), kernels,
            sum(e.count for e in events) / n)


def bound(nbytes, flops, peaks, rate=None):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the flops over ``rate`` (default: bf16 tensor cores)."""
    t_bytes, t_ops = nbytes / peaks[0], flops / (rate or peaks[1])
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_max_err(got, want):
    """max|got - want| / max|want|, in float32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def close(got, want, tol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    return ok, err.max().item()


def ring_valid(gen, b, S):
    """(b, S) ring-buffer validity of rows at random positions in [1, 2S)."""
    pos = torch.randint(1, 2 * S, (b,), generator=gen, device="cuda")
    age = (pos[:, None] % S - torch.arange(S, device="cuda")[None]) % S
    return age <= torch.clamp(pos[:, None], max=S - 1)


def phase_kernels(peaks, flush):
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_lse)
    from repro_torch.kernels.flash_decode import (flash_decode_gqa,
                                                  gqa_decode_ref,
                                                  gqa_decode_splitk)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = {}
    bf16, f32 = torch.bfloat16, torch.float32
    p = PREFILL
    attn_cases = [
        ("prefill", p["b"], p["s"], p["s"], p["H"], p["K"], p["D"], True, 0, bf16),
        ("window64", 2, 512, 512, 24, 8, 128, True, 64, bf16),
        ("noncausal_sq!=sk", 2, 96, 200, 8, 2, 64, False, 0, bf16),
        ("fp32_D32", 2, 160, 160, 8, 4, 32, True, 0, f32),
        ("ragged_s129", 2, 129, 129, 8, 2, 128, True, 0, bf16),
    ]
    for name, b, sq, sk, H, K, D, causal, window, dt in attn_cases:
        q, k, v = randn(b, sq, H, D, dtype=dt), randn(b, sk, K, D, dtype=dt), \
            randn(b, sk, K, D, dtype=dt)
        got, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        ok, err = close(got, want, tol)
        # lse is float32 from float32 scores whatever the inputs' dtype
        ok_lse, err_lse = close(lse, attention_lse_ref(
            q, k, causal=causal, window=window), FP32_TOL)
        print(f"kernel flash_attention {name} b={b} sq={sq} sk={sk} H={H} K={K}"
              f" D={D} causal={causal} window={window} {str(dt)[6:]}:"
              f" max_abs_err={err:.3e} tol={tol:g}, lse max_abs_err="
              f"{err_lse:.3e} tol={FP32_TOL:g} {'ok' if ok and ok_lse else 'FAIL'}")
        check(ok and ok_lse,
              f"flash_attention {name} disagrees with its plain version")
        if name != "prefill":
            continue
        pos_q = torch.arange(sq, device="cuda")[:, None]
        pos_k = torch.arange(sk, device="cuda")[None]
        pairs = int((pos_k <= pos_q).sum()) if causal else sq * sk
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        bound_ms, bound_by = bound(nbytes, 4 * D * b * H * pairs, peaks)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows["flash_attention"] = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:78",
            max_abs_err=err,
            ms=time_ms(lambda: flash_attention(q, k, v, causal=True), flush),
            plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=True), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush))

    d = DECODE
    for name, b, S, H, K, D, dt in [
            ("decode_ring", d["b"], d["S"], d["H"], d["K"], d["D"], bf16),
            ("masked_block", 4, 700, 24, 8, 128, bf16),
            ("invalid_row", 4, 300, 8, 2, 32, f32)]:
        q, k, v = randn(b, 1, H, D, dtype=dt), randn(b, S, K, D, dtype=dt), \
            randn(b, S, K, D, dtype=dt)
        valid = ring_valid(gen, b, S)
        if name == "masked_block":
            valid[:, 256:512] = False
            valid[:, 0] = True
        if name == "invalid_row":
            valid[1] = False
        got = flash_decode_gqa(q, k, v, valid)
        want = gqa_decode_splitk(q, k, v, valid, block_s=256)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        ok, err = close(got, want, tol)
        if name == "invalid_row":
            ok = ok and bool((got[1] == 0).all())
            live = valid.any(dim=1)
            ok_ref, _ = close(got[live], gqa_decode_ref(q[live], k[live], v[live],
                                                        valid[live]), tol)
        else:
            ok_ref, _ = close(got, gqa_decode_ref(q, k, v, valid), tol)
        print(f"kernel flash_decode_gqa {name} b={b} S={S} H={H} K={K} D={D}"
              f" {str(dt)[6:]}: max_abs_err={err:.3e} (vs split-KV plain)"
              f" tol={tol:g} {'ok' if ok and ok_ref else 'FAIL'}")
        check(ok and ok_ref,
              f"flash_decode_gqa {name} disagrees with its plain versions")
        if name != "decode_ring":
            continue
        # the function needs q, the valid rows of K and V and the mask, and
        # writes the output; masked rows are neither read nor computed on
        n_valid = int(valid.sum())
        nbytes = (2 * (q.numel() + got.numel()) + 2 * 2 * K * D * n_valid
                  + valid.numel())
        bound_ms, bound_by = bound(nbytes, 4 * D * H * n_valid, peaks)
        print(f"time flash_decode_gqa inputs: {n_valid} of {b * S} cache rows"
              f" valid, {nbytes} bytes needed")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = valid[:, None, None, :]
        rows["flash_decode_gqa"] = dict(
            name="flash_decode_gqa", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode/flash_decode.py:83",
            max_abs_err=err,
            ms=time_ms(lambda: flash_decode_gqa(q, k, v, valid), flush),
            plain_ms=time_ms(lambda: gqa_decode_ref(q, k, v, valid), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), flush))
    rows.update(phase_mla_kernels(peaks, flush, gen, randn))
    rows.update(phase_attention_bwd(peaks, flush, randn))
    rows.update(phase_adam(peaks, flush, gen))
    rows.update(phase_ssd_kernel(peaks, flush, gen))
    for r in rows.values():
        library = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms,"
              f" plain {r['plain_ms']:.4f} ms, library {library},"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def phase_mla_kernels(peaks, flush, gen, randn):
    """The MLA decode kernel and the forward attention at the MLA head dims
    against their plain versions; the decode's row for the kernels line and
    the D=192 attention's times on a line of their own."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_decode import (flash_decode_mla,
                                                  mla_decode_ref,
                                                  mla_decode_splitk)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    d = MLA_DECODE
    for name, b, S, H, r, dr, dt in [
            ("decode_ring", d["b"], d["S"], d["H"], d["r"], d["dr"], bf16),
            ("fp32", d["b"], d["S"], d["H"], d["r"], d["dr"], f32),
            ("smoke_dims", 8, 544, 8, 32, 16, bf16),
            ("smoke_dims_fp32", 3, 300, 8, 32, 16, f32),
            ("masked_block_S700", 4, 700, 128, 512, 64, bf16),
            ("invalid_row_H20", 4, 300, 20, 512, 16, f32)]:
        q_lat, q_rope = randn(b, H, r, dtype=dt), randn(b, H, dr, dtype=dt)
        c_kv, k_rope = randn(b, S, r, dtype=dt), randn(b, S, dr, dtype=dt)
        valid = ring_valid(gen, b, S)            # ragged: a position per row
        if name.startswith("masked_block"):
            valid[:, 256:512] = False
            valid[:, 0] = True
        if name.startswith("invalid_row"):
            valid[1] = False
        denom = math.sqrt(128 + dr)
        args = (q_lat, q_rope, c_kv, k_rope, valid)
        got = flash_decode_mla(*args, denom=denom)
        want = mla_decode_splitk(*args, denom=denom, block_s=256)
        live = valid.any(dim=1)
        ref = mla_decode_ref(*(t[live] for t in args), denom=denom)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        err, err_ref = rel_max_err(got, want), rel_max_err(got[live], ref)
        ok = err <= tol and err_ref <= tol and bool((got[~live] == 0).all())
        print(f"kernel flash_decode_mla {name} b={b} S={S} H={H} r={r} dr={dr}"
              f" {str(dt)[6:]}: max|d|/max|ref| {err:.3e} (split-KV plain),"
              f" {err_ref:.3e} (whole-cache plain) tol={tol:g}"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_decode_mla {name} disagrees with its plain versions")
        if name != "decode_ring":
            continue
        # the function needs the queries, the valid rows of c_kv and k_rope
        # and the mask, and writes o_lat; per valid row and head it does
        # 2(r + dr) flops of scores and 2r of p.c_kv
        n_valid = int(valid.sum())
        nbytes = (2 * (q_lat.numel() + q_rope.numel() + got.numel())
                  + 2 * (r + dr) * n_valid + valid.numel())
        bound_ms, bound_by = bound(nbytes, H * n_valid * (4 * r + 2 * dr),
                                   peaks)
        print(f"time flash_decode_mla inputs: {n_valid} of {b * S} cache rows"
              f" valid, {nbytes} bytes needed; library is SDPA on the MQA"
              f" form (one shared key [c_kv | k_rope], value c_kv)")
        qm = torch.cat([q_lat, q_rope], dim=-1)[:, :, None]   # (b, H, 1, r+dr)
        km = torch.cat([c_kv, k_rope], dim=-1)[:, None]       # (b, 1, S, r+dr)
        vm = c_kv[:, None]
        mask = valid[:, None, None, :]
        rows["flash_decode_mla"] = dict(
            name="flash_decode_mla", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode_mla.cu",
            replaces="src/repro/kernels/flash_decode/flash_decode.py:158",
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            ms=time_ms(lambda: flash_decode_mla(*args, denom=denom), flush),
            plain_ms=time_ms(lambda: mla_decode_ref(*args, denom=denom), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qm, km, vm, attn_mask=mask, scale=1.0 / denom,
                enable_gqa=True), flush))

    p = MLA_PREFILL
    for name, b, s, H, D, dt in [("mla_prefill", p["b"], p["s"], p["H"], p["D"], bf16),
                                 ("smoke_dims", 2, 512, 8, 48, bf16),
                                 ("fp32_ragged", 2, 100, 8, 48, f32),
                                 ("fp32_ragged", 2, 100, 8, 192, f32)]:
        q, k, v = (randn(b, s, H, D, dtype=dt) for _ in range(3))
        scale = D ** -0.5
        got = flash_attention(q, k, v, causal=True, softmax_scale=scale)
        want = attention_ref(q, k, v, causal=True, softmax_scale=scale)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        err = rel_max_err(got, want)
        print(f"kernel flash_attention {name} b={b} s={s} H=K={H} D={D} causal"
              f" {str(dt)[6:]}: max|d|/max|ref| {err:.3e} tol={tol:g}"
              f" {'ok' if err <= tol else 'FAIL'}")
        check(err <= tol, f"flash_attention D={D} {name} disagrees with its"
                          f" plain version")
        if name != "mla_prefill":
            continue
        nbytes = 2 * 4 * q.numel()
        bound_ms, bound_by = bound(nbytes, 4 * D * b * H * (s * (s + 1) // 2),
                                   peaks)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                             softmax_scale=scale), flush)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True,
                                                 softmax_scale=scale), flush)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale), flush)
        print(f"time flash_attention D=192 (deepseek-v2 MLA prefill b={b}"
              f" s={s} H=K={H}, {nbytes} bytes): kernel {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, library {library_ms:.4f} ms (SDPA), bound"
              f" {bound_ms:.4f} ms ({bound_by}), max_abs_err"
              f" {(got.float() - want.float()).abs().max().item():.3e}")
    return rows


def phase_attention_bwd(peaks, flush, randn):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention_bwd,
                                                     flash_attention_lse)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    for name, b, sq, sk, H, K, D, causal, window, dt in [
            ("train", 1, 1024, 1024, 16, 16, 64, True, 0, bf16),
            ("window64", 2, 512, 512, 24, 8, 128, True, 64, bf16),
            ("gqa", 2, 512, 512, 24, 8, 128, True, 0, bf16),
            ("noncausal_sq!=sk", 2, 96, 200, 8, 2, 64, False, 0, bf16),
            ("fp32_D32", 2, 160, 160, 8, 4, 32, True, 0, f32),
            ("ragged", 2, 100, 100, 8, 4, 64, True, 0, bf16)]:
        kw = dict(causal=causal, window=window)
        q, k, v = randn(b, sq, H, D, dtype=dt), randn(b, sk, K, D, dtype=dt), \
            randn(b, sk, K, D, dtype=dt)
        do = randn(b, sq, H, D, dtype=dt)
        o, lse = flash_attention_lse(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        explicit = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        attention_ref(*leaves, **kw).backward(do)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        err = max(rel_max_err(g, e) for g, e in zip(got, explicit))
        err_ag = max(rel_max_err(g, t.grad) for g, t in zip(got, leaves))
        ok = err <= tol and err_ag <= tol and same
        print(f"kernel flash_attention_bwd {name} b={b} sq={sq} sk={sk} H={H}"
              f" K={K} D={D} causal={causal} window={window} {str(dt)[6:]}:"
              f" max|d|/max|ref| {err:.3e} (explicit), {err_ag:.3e}"
              f" (autograd) tol={tol:g}, bit-identical rerun {same}"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention_bwd {name} disagrees with its plain"
                  f" versions or is not deterministic")
        if name != "train":
            continue
        pairs = sq * (sq + 1) // 2
        nbytes = 2 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
            + 4 * lse.numel()
        # the gradient's five products (S, dP, dV, dK, dQ) over the causal
        # pairs: 2.5x the forward's two
        bound_ms, bound_by = bound(nbytes, 10 * D * b * H * pairs, peaks)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        # the library time: SDPA's backward alone (one autograd.grad on a
        # retained graph), under each of its backends, the fastest kept --
        # the default choice moved between runs (cuDNN's ~0.044 ms, the
        # memory-efficient kernel's ~0.14 ms)
        library = {}
        for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                library[backend.name] = time_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True), flush)
            del out
        rows["flash_attention_bwd"] = dict(
            name="flash_attention_bwd", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:78"
                     " (its gradient)",
            max_abs_err=max((g.float() - e.float()).abs().max().item()
                            for g, e in zip(got, explicit)),
            ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
                       flush),
            plain_ms=time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                       **kw), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=min(library.values()))
        print("time flash_attention_bwd library: SDPA backward alone, "
              + ", ".join(f"{k} {ms:.4f} ms" for k, ms in library.items()))
    return rows


def phase_adam(peaks, flush, gen):
    from repro_torch.kernels.adam_update import adam_ref, adam_update
    rows = {}
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1, c1=0.5,
              c2=0.2)
    for shape in [(37,), (1000,), (64, 130), (4096,), (24, 1024, 4096)]:
        g = torch.randn(shape, generator=gen, device="cuda")
        m = torch.randn(shape, generator=gen, device="cuda") * 0.1
        v = torch.randn(shape, generator=gen, device="cuda").abs() * 0.01
        mp = torch.randn(shape, generator=gen, device="cuda")
        want = adam_ref(g, m, v, mp, **kw)
        param = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        adam_update(g, m, v, mp, param, **kw)
        errs = [(a - w).abs().max().item() for a, w in zip((m, v, mp), want)]
        ok = all(bool(((a - w).abs() <= ADAM_ATOL + ADAM_RTOL * w.abs()).all())
                 for a, w in zip((m, v, mp), want))
        ok = ok and torch.equal(param, mp.to(torch.bfloat16))
        print(f"kernel adam_update n={g.numel()} shape={shape}: max_abs_err"
              f" m {errs[0]:.3e} v {errs[1]:.3e} master {errs[2]:.3e}"
              f" atol={ADAM_ATOL:g} rtol={ADAM_RTOL:g}, param = bf16(master')"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"adam_update n={g.numel()} disagrees with its plain version")
        if len(shape) < 3:
            continue
        n = g.numel()
        # reads g, m, v, master; writes m, v, master and the bf16 param;
        # ~15 float32 operations an element on the CUDA cores
        bound_ms, bound_by = bound(30 * n, 15 * n, peaks, rate=peaks[2])
        w = g.clone().requires_grad_(True)
        w.grad = g
        opt = torch.optim.AdamW([w], lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
        opt.step()                       # creates its m and v
        rows["adam_update"] = dict(
            name="adam_update", route="cuda",
            source="src/repro_torch/kernels/csrc/adam_update.cu",
            replaces="src/repro/kernels/adam_update/adam_update.py:40",
            max_abs_err=max(errs),
            ms=time_ms(lambda: adam_update(g, m, v, mp, param, **kw), flush),
            plain_ms=time_ms(lambda: adam_ref(g, m, v, mp, **kw), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(opt.step, flush))
        print(f"time adam_update inputs: one leaf of {n} parameters"
              f" (gpt2-350m's ffn.w1), {30 * n} bytes; library is"
              f" torch.optim.AdamW(fused=True).step() on the same float32"
              f" leaf, which updates m, v and the weights but writes no bf16"
              f" copy")
        del opt, w
    return rows


def phase_ssd_kernel(peaks, flush, gen):
    """The SSD scan against its plain version at the serving path's shape
    and at edge cases; its row for the kernels line, and the 32k prompt's
    times on a line of their own."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import chunk
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    p, q = SSD_PREFILL, SSD_LONG
    for name, b, s, h, P, N, dt in [
            ("prefill", p["b"], p["s"], p["h"], p["P"], p["N"], bf16),
            ("prefill_32k", q["b"], q["s"], q["h"], q["P"], q["N"], bf16),
            ("ragged", 2, 1000, 24, 64, 128, bf16),
            ("fp32_ragged", 2, 1000, 24, 64, 128, f32),
            ("smoke_dims", 2, 200, 16, 32, 16, bf16),
            ("smoke_dims_fp32", 3, 77, 16, 32, 16, f32)]:
        # the JAX package's kernel sweep's inputs (tests/test_kernels.py:44-52)
        x = torch.randn(b, s, h, P, generator=gen, device="cuda").to(dt)
        dt_raw = (torch.randn(b, s, h, generator=gen, device="cuda") * 0.5).to(dt)
        A_log = torch.randn(h, generator=gen, device="cuda") * 0.3
        B = torch.randn(b, s, N, generator=gen, device="cuda").to(dt)
        C = torch.randn(b, s, N, generator=gen, device="cuda").to(dt)
        D = torch.randn(h, generator=gen, device="cuda")
        dt_bias = torch.full((h,), 0.1, device="cuda")
        args = (x, dt_raw, A_log, B, C, D, dt_bias)
        got = ssd_scan(*args)
        want = ssd_scan_ref(*args)
        tol = SSD_BF16_TOL if dt == bf16 else SSD_FP32_TOL
        (ok_y, err_y), (ok_s, err_s) = (close(g, w, tol)
                                        for g, w in zip(got, want))
        print(f"kernel ssd_scan {name} b={b} s={s} h={h} P={P} N={N}"
              f" {str(dt)[6:]}: y max_abs_err={err_y:.3e} (max|ref|"
              f" {want[0].float().abs().max().item():.3f}), state"
              f" max_abs_err={err_s:.3e} (max|ref|"
              f" {want[1].abs().max().item():.3f}) tol={tol:g}"
              f" {'ok' if ok_y and ok_s else 'FAIL'}")
        check(ok_y and ok_s, f"ssd_scan {name} disagrees with its plain version")
        if not name.startswith("prefill"):
            continue
        # reads x, dt_raw, B, C and the (h,) vectors, writes y and the
        # float32 state; products of the chunked form at the kernel's chunk
        # L: C.B^T (2 L^2 N), W.x (2 L^2 P), C.state and the state update
        # (2 L N P each) per (batch, head, chunk)
        L = chunk()
        nbytes = (x.element_size() * (2 * x.numel() + dt_raw.numel()
                                      + B.numel() + C.numel())
                  + 4 * (want[1].numel() + 3 * h))
        flops = b * h * -(-s // L) * (2 * L * L * (N + P) + 4 * L * N * P)
        bound_ms, bound_by = bound(nbytes, flops, peaks)
        ms = time_ms(lambda: ssd_scan(*args), flush)
        plain_ms = time_ms(lambda: ssd_scan_ref(*args), flush)
        print(f"time ssd_scan {name} inputs: {nbytes} bytes, {flops} flops of"
              f" the chunked form at L={L}: kernel {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by});"
              f" no PyTorch call computes the scan")
        if name == "prefill":
            rows["ssd_scan"] = dict(
                name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/ssd_scan.py:76",
                max_abs_err=max(err_y, err_s), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return rows


def serve_main_path(cfg, params, prompt, new, want_launches):
    """(a) batch prefill + greedy decode with the launch counts set to 0
    just before and read just after, after a warm-up run; then a
    torch.profiler trace of one prefill and one decode step.  Returns
    (tokens, launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import prefill, serve_step
    b, s = prompt.shape
    cache_len = s + new

    def run_main():
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        toks = [tok]
        for i in range(new - 1):
            logits, cache = serve_step(cfg, params, tok, cache, s + i)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            toks.append(tok)
        torch.cuda.synchronize()
        return torch.cat(toks, dim=1), logits, t1

    run_main()                                          # warm-up
    reset_launches()
    t0 = time.perf_counter()
    toks, last_logits, t1 = run_main()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)
    prefill_tok_s = b * s / (t1 - t0)
    decode_tok_s = b * (new - 1) / (t2 - t1)
    print(f"(a) serve b={b} prompt={s} new={new} cache_len={cache_len}:"
          f" prefill {t1 - t0:.4f}s {prefill_tok_s:.1f} tok/s, decode"
          f" {new - 1} steps {t2 - t1:.4f}s {decode_tok_s:.1f} tok/s,"
          f" launches {launches}")
    check(tuple(toks.shape) == (b, new)
          and bool(torch.isfinite(last_logits.float()).all())
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "main path produced malformed tokens or non-finite logits")
    check(launches == want_launches,
          f"main path launch counts {launches} != {want_launches}")

    # the device's busy time in one prefill and one decode step, against
    # their wall time above; the profiled runs are not counted in launches
    _, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
    tok = toks[:, :1]
    for what, fn, n, wall_ms in (
            ("prefill", lambda: prefill(cfg, params, {"tokens": prompt}, cache_len),
             2, (t1 - t0) * 1e3),
            ("decode step", lambda: serve_step(cfg, params, tok, cache, s),
             8, (t2 - t1) * 1e3 / (new - 1))):
        busy, kernels, _ = device_profile(fn, n)
        if busy == 0:
            print(f"(a) trace {what}: the profiler saw no device time;"
                  " idle share not measured")
            continue
        top = "; ".join(f"{k[:48]} {ms:.4f}" for k, ms in kernels[:6])
        print(f"(a) trace {what}: device busy {busy:.4f} ms of {wall_ms:.4f} ms"
              f" wall, idle share {1 - busy / wall_ms:.3f}; top kernels (ms per"
              f" call): {top}")
    return toks, launches


def serve_batchers(cfg, params, prompts, new):
    """(c) the requests through 8 slots of the continuous and the
    disaggregated batchers, against per-request greedy decoding (the share
    that agrees, and where the others first differ, are reported, not
    required); then the first decode step of requests 0-7, each alone
    against the same rows as one batch of 8 (what the batchers run), which
    measures how far a step's logits depend on the batch around a row on
    this card."""
    from repro_torch.serve import (ContinuousBatcher, DisaggregatedBatcher,
                                   ServeRequest, greedy_decode, prefill,
                                   serve_step)
    n, s = prompts.shape
    cache_len = s + new
    want = {i: greedy_decode(cfg, params, prompts[i:i + 1], new, cache_len)[0].tolist()
            for i in range(n)}
    for cls in (ContinuousBatcher, DisaggregatedBatcher):
        cb = cls(cfg, params, slots=8, cache_len=cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            cb.submit(ServeRequest(i, prompts[i], new))
        out = cb.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_tok = sum(len(t) for t in out.values())
        check(sorted(out) == list(range(n))
              and all(len(t) == new for t in out.values()),
              f"{cls.__name__} did not serve all {n} requests")
        same = sum(out[i] == want[i] for i in range(n)) / n
        first = [next(k for k, (a, c) in enumerate(zip(out[i], want[i])) if a != c)
                 for i in range(n) if out[i] != want[i]]
        print(f"(c) {cls.__name__}: {len(out)} requests, {n_tok} tokens,"
              f" {cb.decode_steps} decode steps, {dt:.3f}s {n_tok / dt:.1f} tok/s,"
              f" share equal to per-request greedy {same:.3f}; the others"
              f" first differ at token {first}")
    caches = [prefill(cfg, params, {"tokens": prompts[i:i + 1]}, cache_len)[1]
              for i in range(8)]
    batch = {j: {k: torch.cat([c[j][k] for c in caches], dim=1) for k in sub}
             for j, sub in caches[0].items()}
    tok = torch.tensor([[want[i][0]] for i in range(8)], device="cuda")
    alone = torch.cat([serve_step(cfg, params, tok[i:i + 1], caches[i], s)[0]
                       for i in range(8)])
    together, _ = serve_step(cfg, params, tok, batch, s)
    print(f"(c) first decode step of requests 0-7, each alone vs as one batch"
          f" of 8: max|dlogit|/max|logit| {rel_max_err(together, alone):.3e}")


def phase_model():
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, dispatch
    from repro_torch.models import init_params
    from repro_torch.serve import prefill, serve_step
    cfg = get_arch("llama3.2-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model}"
          f" heads={cfg.num_heads}/{cfg.num_kv_heads} vocab={cfg.vocab_size}"
          f" params={n_params} bf16 init {time.perf_counter() - t0:.1f}s")
    b, s, new = 8, 512, 32
    cache_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(flash_attention=cfg.num_layers,
                flash_decode_gqa=cfg.num_layers * (new - 1))
    toks, launches = serve_main_path(cfg, params, prompt, new, want)

    # (b) kernel path against the plain path: prefill logits, first decode
    def first_two():
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        step, _ = serve_step(cfg, params, tok_fixed, cache, s)
        return logits[:, -1].float(), step[:, -1].float()

    tok_fixed = toks[:, :1]
    kern = first_two()
    with dispatch.force("ref"):
        plain = first_two()
    rel = [((a - c).abs().max() / c.abs().max()).item() for a, c in zip(kern, plain)]
    print(f"(b) kernel vs plain path: prefill max|dlogit|/max|logit|={rel[0]:.3e},"
          f" first decode {rel[1]:.3e}, tol {LOGITS_TOL:g}")
    check(max(rel) <= LOGITS_TOL, "kernel path logits differ from the plain path")

    # (c) 16 requests through 8 slots, against per-request greedy decoding
    prompts = torch.randint(0, cfg.vocab_size, (16, s), generator=gen, device="cuda")
    serve_batchers(cfg, params, prompts, new)
    return launches


def phase_deepseek():
    """deepseek-v2-236b, published widths, DEEPSEEK_LAYERS of 60 layers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, dispatch
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params, moe, param_count
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import cache_from_prefill
    from repro_torch.serve import prefill, serve_step
    cfg = get_arch("deepseek-v2-236b").scaled(num_layers=DEEPSEEK_LAYERS)
    n_params = param_count(cfg)
    check(n_params == 16_937_047_040, f"deepseek-v2 at 4 layers has {n_params}"
                                      f" parameters")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.num_layers} of 60 layers, d_model={cfg.d_model}"
          f" heads={cfg.num_heads} MLA q_lora={cfg.q_lora_rank}"
          f" kv_lora={cfg.kv_lora_rank} dn/dr/dv={cfg.qk_nope_head_dim}/"
          f"{cfg.qk_rope_head_dim}/{cfg.v_head_dim} experts={cfg.num_experts}"
          f" routed top-{cfg.top_k} + {cfg.num_shared_experts} shared of"
          f" d_ff {cfg.moe_d_ff} vocab={cfg.vocab_size} params={n_params}"
          f" ({n_bytes} bytes, bf16 with a float32 router), init"
          f" {time.perf_counter() - t0:.1f}s")
    b, s, new = 8, 512, 32
    cache_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(flash_attention=cfg.num_layers,
                flash_decode_mla=cfg.num_layers * (new - 1))
    toks, launches = serve_main_path(cfg, params, prompt, new, want)

    # (b1) layer 0's MLA, which no routing precedes: prefill output, and the
    # first decode step over the cache that prefill wrote
    p0 = {k: v[0] for k, v in params["blocks"]["sub0"]["mixer"].items()}
    norm1 = params["blocks"]["sub0"]["norm1"][0]
    h = rms_norm(params["embed"][prompt], norm1, cfg.norm_eps)
    h_new = rms_norm(params["embed"][toks[:, :1]], norm1, cfg.norm_eps)
    positions = torch.arange(s, device="cuda")

    def layer0():
        with torch.inference_mode():
            out, kv = attn.mla_attend_train(cfg, p0, h, positions)
            ring = cache_from_prefill(cfg, {"sub0": {k: t[None] for k, t in
                                                     kv.items()}}, cache_len)
            step, _ = attn.mla_attend_decode(
                cfg, p0, h_new, {k: t[0] for k, t in ring["sub0"].items()},
                attn.ring_index(s, cache_len, b, "cuda"))
        return out, step

    kern = layer0()
    with dispatch.force("ref"):
        plain = layer0()
    rel = [rel_max_err(a, c) for a, c in zip(kern, plain)]
    print(f"(b) layer 0 MLA, kernel vs plain: prefill max|d|/max|ref|"
          f" {rel[0]:.3e}, first decode step {rel[1]:.3e}, tol {BF16_TOL:g}")
    check(max(rel) <= BF16_TOL, "layer 0's MLA differs from the plain path")

    # (b2) the whole model: prefill logits and the first decode step's, and
    # the routing choices (each token's top-k set) of both paths
    routes = []
    inner = moe.moe_ffn

    def spy(cfg_, p, x):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        routes.append(torch.topk(probs, cfg_.top_k, dim=-1).indices.sort(-1).values)
        return inner(cfg_, p, x)

    def first_two():
        routes.clear()
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        step, _ = serve_step(cfg, params, toks[:, :1], cache, s)
        return logits[:, -1].float(), step[:, -1].float(), list(routes)

    moe.moe_ffn = spy
    try:
        kern = first_two()
        with dispatch.force("ref"):
            plain = first_two()
    finally:
        moe.moe_ffn = inner
    agree = (sum(int((a == c).all(-1).sum()) for a, c in zip(kern[2], plain[2]))
             / sum(a.shape[0] * a.shape[1] for a in kern[2]))
    dl = [(a - c).abs().max().item() for a, c in zip(kern[:2], plain[:2])]
    scale = max(c.abs().max().item() for c in plain[:2])
    print(f"(b) kernel vs plain path: prefill max|dlogit| {dl[0]:.3e},"
          f" first decode {dl[1]:.3e} (max|logit| {scale:.3f}), atol"
          f" {DEEPSEEK_LOGITS_ATOL:g}; share of routing choices (a token's"
          f" top-{cfg.top_k} set in one layer, prefill and first decode step)"
          f" equal on both paths: {agree:.4f}")
    check(max(dl) <= DEEPSEEK_LOGITS_ATOL,
          "deepseek-v2 kernel path logits differ from the plain path")

    # (c) 16 requests through 8 slots
    prompts = torch.randint(0, cfg.vocab_size, (16, s), generator=gen, device="cuda")
    serve_batchers(cfg, params, prompts, new)
    return launches


def phase_mamba2():
    """mamba2-130m at full width and depth."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, dispatch, reset_launches
    from repro_torch.models import init_params, param_count
    from repro_torch.models.common import rms_norm
    from repro_torch.models.mamba2 import mamba2_forward
    from repro_torch.serve import prefill, serve_step
    cfg = get_arch("mamba2-130m")
    n_params = param_count(cfg)
    check(n_params == 167_598_528, f"mamba2-130m has {n_params} parameters")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model}"
          f" d_inner={cfg.d_inner} ssd heads={cfg.n_ssm_heads} of"
          f" P={cfg.ssm_head_dim} state N={cfg.ssm_state} conv={cfg.ssm_conv}"
          f" vocab={cfg.vocab_size} params={n_params} ({n_bytes} bytes, bf16"
          f" with float32 A_log/D/dt_bias), init {time.perf_counter() - t0:.1f}s")
    b, s, new = 8, 512, 32
    cache_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(ssd_scan=cfg.num_layers)
    toks, launches = serve_main_path(cfg, params, prompt, new, want)

    # (a') one prompt of 32,768 tokens, timed after a warm-up prefill
    s_long = SSD_LONG["s"]
    long_prompt = torch.randint(0, cfg.vocab_size, (1, s_long), generator=gen,
                                device="cuda")
    prefill(cfg, params, {"tokens": long_prompt}, s_long + 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = prefill(cfg, params, {"tokens": long_prompt}, s_long + 1)
    torch.cuda.synchronize()
    dt_long = time.perf_counter() - t0
    print(f"(a') prefill b=1 prompt={s_long}: {dt_long:.4f}s"
          f" {s_long / dt_long:.1f} tok/s, launches {dict(LAUNCHES)}")
    check(LAUNCHES["ssd_scan"] == cfg.num_layers
          and bool(torch.isfinite(logits.float()).all()),
          "the 32k prefill did not run the kernel once a layer or gave"
          " non-finite logits")

    # (b1) layer 0's mixer: output and final SSD state, kernel vs plain
    p0 = {k: v[0] for k, v in params["blocks"]["sub0"]["mixer"].items()}
    h = rms_norm(params["embed"][prompt], params["blocks"]["sub0"]["norm1"][0],
                 cfg.norm_eps)

    def layer0():
        with torch.inference_mode():
            out, cache = mamba2_forward(cfg, p0, h)
        return out, cache["ssd"]

    kern = layer0()
    with dispatch.force("ref"):
        plain = layer0()
    rel = [rel_max_err(a, c) for a, c in zip(kern, plain)]
    print(f"(b) layer 0 Mamba2 mixer, kernel vs plain: output max|d|/max|ref|"
          f" {rel[0]:.3e}, final SSD state {rel[1]:.3e}, tol {MAMBA2_TOL:g}")
    check(max(rel) <= MAMBA2_TOL, "layer 0's Mamba2 mixer differs from the"
                                  " plain path")

    # (b2) the whole model: prefill logits and the first decode step's
    def first_two():
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        step, _ = serve_step(cfg, params, toks[:, :1], cache, s)
        return logits[:, -1].float(), step[:, -1].float()

    kern = first_two()
    with dispatch.force("ref"):
        plain = first_two()
    rel = [rel_max_err(a, c) for a, c in zip(kern, plain)]
    print(f"(b) kernel vs plain path: prefill max|dlogit|/max|logit|={rel[0]:.3e},"
          f" first decode {rel[1]:.3e}, tol {MAMBA2_TOL:g}")
    check(max(rel) <= MAMBA2_TOL, "mamba2 kernel path logits differ from the"
                                  " plain path")

    # (c) 16 requests through 8 slots; then the decode step's one product
    # whose sum order depends on the batch: C . state in float32 (a cuBLAS
    # batched product), one row at a time against 8 rows at once
    prompts = torch.randint(0, cfg.vocab_size, (16, s), generator=gen, device="cuda")
    serve_batchers(cfg, params, prompts, new)
    C = torch.randn(8, cfg.ssm_state, generator=gen, device="cuda")
    state = torch.randn(8, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                        generator=gen, device="cuda")
    one = torch.cat([torch.einsum("bn,bhpn->bhp", C[i:i + 1], state[i:i + 1])
                     for i in range(8)])
    eight = torch.einsum("bn,bhpn->bhp", C, state)
    print(f"(c) mamba2_decode's float32 C . state at batch 8 vs one row at a"
          f" time: max|d| {(eight - one).abs().max().item():.3e}, bit-identical"
          f" {torch.equal(eight, one)}")
    return launches


def phase_train(peaks):
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import LAUNCHES, dispatch, reset_launches
    from repro_torch.launch.train import loss_fell, to_device, train
    from repro_torch.models import param_count
    from repro_torch.train import accumulate_grads, build_train_step
    from repro_torch.train.optimizer import global_norm
    cfg = get_arch("gpt2-350m")
    n_params = param_count(cfg)
    check(n_params == 353_503_232, f"gpt2-350m has {n_params} parameters")
    b, s, steps = 8, 1024, 13             # 1 warm-up + 12 timed steps
    tc = TrainConfig(global_batch=b, seq_len=s, microbatch=1, steps=steps,
                     warmup_steps=1, remat="block", seed=0)
    print(f"model {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model}"
          f" heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff}"
          f" vocab={cfg.vocab_size} params={n_params}; train global_batch={b}"
          f" seq={s} microbatch=1 remat=block, {steps} steps")
    reset_launches()
    out = train(cfg, tc, device="cuda", log_every=1,
                log=lambda line: print(f"(t) {line}"))
    launches = dict(LAUNCHES)
    n_micro = out["n_micro"]
    want = {"flash_attention": 2 * cfg.num_layers * n_micro * steps,
            "flash_attention_bwd": cfg.num_layers * n_micro * steps,
            "adam_update": 10 * steps, "flash_decode_gqa": 0,
            "flash_decode_mla": 0, "ssd_scan": 0}
    losses, step_s = out["losses"], out["step_s"][1:]
    step_ms = 1e3 * sum(step_s) / len(step_s)
    tokens = b * s
    pairs = s * (s + 1) // 2
    attn_flops = 12 * cfg.num_layers * b * cfg.num_heads * cfg.head_dim * pairs
    mfu = (6 * n_params * tokens + attn_flops) / (step_ms * 1e-3 * peaks[1])
    print(f"(t) train: {len(step_s)} timed steps, step {step_ms:.2f} ms (min"
          f" {1e3 * min(step_s):.2f}, max {1e3 * max(step_s):.2f}),"
          f" {tokens / (step_ms * 1e-3):.1f} tokens/s, MFU {mfu:.4f}"
          f" ((6 N tokens + {attn_flops:.3e} attention flops) / (step x"
          f" {peaks[1]:.3g})), launches {launches}")
    peak = out["peak_bytes"]
    print(f"(t) peak device memory over step 1: {peak} B"
          f" ({peak / 2**30:.3f} GiB); the JAX package's exact_peak_bytes"
          f" prediction for the cell: {JAX_PREDICTED_PEAK} B"
          f" ({JAX_PREDICTED_PEAK / 2**30:.3f} GiB)")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(loss_fell(losses), f"loss did not fall: {losses}")
    check(launches == want, f"training path launch counts {launches} != {want}")

    # the device's busy time in one step against its wall time above
    state = out["state"]
    step, _ = build_train_step(cfg, tc, b, s)
    batch = to_device(next(SyntheticTokens(cfg, b, s, seed=1)), "cuda")
    busy, kernels, n_events = device_profile(lambda: step(state, batch), 1)
    if busy == 0:
        print("(t) trace step: the profiler saw no device time; idle share"
              " not measured")
    else:
        top = "; ".join(f"{k[:48]} {ms:.3f}" for k, ms in kernels[:10])
        print(f"(t) trace step: device busy {busy:.2f} ms of {step_ms:.2f} ms"
              f" wall, idle share {1 - busy / step_ms:.3f}, {n_events:.0f}"
              f" device events ({(step_ms - busy) * 1e3 / n_events:.1f} us of"
              f" idle per event); top kernels (ms per step): {top}")

    # one full-width microbatch, kernel path against the plain path
    micro = {k: t[:1] for k, t in batch.items()}
    res = []
    for impl in (None, "ref"):
        with dispatch.force(impl):
            grads, loss = accumulate_grads(cfg, tc, state["params"], micro, 1)
            res.append((loss.item(), global_norm(grads).item()))
        del grads
    (lk, gk), (lp, gp) = res
    rl, rg = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    print(f"(t) kernel vs plain path, one microbatch b=1 s={s}: loss {lk:.6f}"
          f" vs {lp:.6f} (rel {rl:.3e}, tol {LOSS_RTOL:g}), grad norm"
          f" {gk:.6f} vs {gp:.6f} (rel {rg:.3e}, tol {GNORM_RTOL:g})")
    check(rl <= LOSS_RTOL and rg <= GNORM_RTOL,
          "training kernel path differs from the plain path")
    return launches


def timed_phase(name, fn):
    """Run one phase, print its wall time, and free what it left on the
    card (its weights) before the next phase starts."""
    t0 = time.perf_counter()
    out = fn()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase {name}: {time.perf_counter() - t0:.1f}s wall")
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in smi), None)
    check(peaks is not None, f"no peak rates on record for {smi!r}")
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | kernels built in {build_s:.1f}s")
    report_build()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = timed_phase("kernels", lambda: phase_kernels(peaks, flush))
    del flush
    # launches: the sum over the four main-path runs, each counted from 0
    path_launches = [timed_phase("llama3.2-3b serving", phase_model),
                     timed_phase("deepseek-v2-236b serving", phase_deepseek),
                     timed_phase("mamba2-130m serving", phase_mamba2),
                     timed_phase("gpt2-350m training", lambda: phase_train(peaks))]
    for kname, row in rows.items():
        row["launches"] = sum(launches[kname] for launches in path_launches)
    print(f"total wall time {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [rows[k] for k in (
        "flash_attention", "flash_attention_bwd", "flash_decode_gqa",
        "flash_decode_mla", "adam_update", "ssd_scan")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
