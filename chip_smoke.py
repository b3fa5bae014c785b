#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it and at edge cases (window, sq != sk, float32,
   a ragged cache tail, a fully masked cache block, an all-invalid row),
   with its time, the plain version's, one PyTorch library call's and the
   card's bound for the same work;
3. llama3.2-3b at full width in bfloat16 with random weights from a seed:
   (a) batch prefill + greedy decode -- the main path, run with the launch
   counts set to 0 just before and read just after, then a torch.profiler
   trace of one prefill and one decode step for the device's busy time and
   idle share and the largest kernels; (b) its logits against
   the same path on the plain versions; (c) 16 requests through the
   continuous and the disaggregated batchers.

Then one JSON line of per-kernel numbers and, last, the JSON result line.
Any failed check raises and the script exits non-zero.  Without a CUDA
card, or without the repository around it, it exits non-zero and prints
no result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# (bytes/s, bf16 dense FLOP/s) from NVIDIA's data sheets, by nvidia-smi name
PEAKS = {"H100 80GB HBM3": (3.35e12, 989e12),     # SXM5
         "H100 PCIe": (2.0e12, 756e12),
         "H100 NVL": (3.9e12, 835e12)}
BF16_TOL, FP32_TOL = 2e-2, 2e-5
# Kernel path vs plain path, max |logit delta| / max |logit|, bf16 at full
# width: the two paths round attention differently (p to bf16 before PV in
# the kernels, float32 throughout in the plain versions; bf16 steps are
# 2^-8 = 3.9e-3 relative) and 28 residual layers carry such one-step
# differences to the logits.  A wrong mask, head mapping or merge moves
# the logits by the order of their own scale.
LOGITS_TOL = 5e-2

SPIN_CYCLES = 2_000_000    # ~1 ms at the H100's ~2 GHz: covers a call's host work

PREFILL = dict(b=8, s=512, H=24, K=8, D=128)
DECODE = dict(b=8, S=544, H=24, K=8, D=128)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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
    trace: (busy ms, [(kernel name, ms)] largest first).  Busy is the sum of
    the device events' durations; the path runs on one stream, so they do
    not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    return sum(ms for _, ms in kernels), kernels


def bound(nbytes, flops, peaks):
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
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
    ]
    for name, b, sq, sk, H, K, D, causal, window, dt in attn_cases:
        q, k, v = randn(b, sq, H, D, dtype=dt), randn(b, sk, K, D, dtype=dt), \
            randn(b, sk, K, D, dtype=dt)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        ok, err = close(got, want, tol)
        print(f"kernel flash_attention {name} b={b} sq={sq} sk={sk} H={H} K={K}"
              f" D={D} causal={causal} window={window} {str(dt)[6:]}:"
              f" max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention {name} disagrees with its plain version")
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
    for r in rows.values():
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms,"
              f" plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def phase_model():
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, dispatch, reset_launches
    from repro_torch.models import init_params
    from repro_torch.serve import (ContinuousBatcher, DisaggregatedBatcher,
                                   ServeRequest, greedy_decode, prefill,
                                   serve_step)
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
    check(launches["flash_attention"] == cfg.num_layers
          and launches["flash_decode_gqa"] == cfg.num_layers * (new - 1),
          f"main path launch counts {launches}")

    # the device's busy time in one prefill and one decode step, against
    # their wall time above; the profiled runs are not counted in launches
    _, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
    tok = toks[:, :1]
    for what, fn, n, wall_ms in (
            ("prefill", lambda: prefill(cfg, params, {"tokens": prompt}, cache_len),
             2, (t1 - t0) * 1e3),
            ("decode step", lambda: serve_step(cfg, params, tok, cache, s),
             8, (t2 - t1) * 1e3 / (new - 1))):
        busy, kernels = device_profile(fn, n)
        if busy == 0:
            print(f"(a) trace {what}: the profiler saw no device time;"
                  " idle share not measured")
            continue
        top = "; ".join(f"{k[:48]} {ms:.4f}" for k, ms in kernels[:6])
        print(f"(a) trace {what}: device busy {busy:.4f} ms of {wall_ms:.4f} ms"
              f" wall, idle share {1 - busy / wall_ms:.3f}; top kernels (ms per"
              f" call): {top}")

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
    want = {i: greedy_decode(cfg, params, prompts[i:i + 1], new, cache_len)[0].tolist()
            for i in range(16)}
    for cls in (ContinuousBatcher, DisaggregatedBatcher):
        cb = cls(cfg, params, slots=8, cache_len=cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(16):
            cb.submit(ServeRequest(i, prompts[i], new))
        out = cb.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_tok = sum(len(t) for t in out.values())
        same = sum(out[i] == want[i] for i in range(16)) / 16
        print(f"(c) {cls.__name__}: {len(out)} requests, {n_tok} tokens,"
              f" {cb.decode_steps} decode steps, {dt:.3f}s {n_tok / dt:.1f} tok/s,"
              f" share equal to per-request greedy {same:.3f}")
        check(sorted(out) == list(range(16))
              and all(len(t) == new for t in out.values()),
              f"{cls.__name__} did not serve all 16 requests")
    return launches


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

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = phase_kernels(peaks, flush)
    del flush
    launches = phase_model()
    for kname, row in rows.items():
        row["launches"] = launches[kname]
    print(json.dumps({"kernels": [rows["flash_attention"], rows["flash_decode_gqa"]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
