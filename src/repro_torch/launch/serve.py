"""Batched serving driver: prefill a batch of prompts, decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --batch 8 --prompt-len 512 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --smoke --device cpu                           # plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --smoke --device cpu   # MLA + MoE
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mamba2-130m --smoke --device cpu        # Mamba2 SSD
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --device cpu   # hybrid
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llava-next-34b --smoke --device cpu     # modal prefix

``--arch`` takes every arch of ``repro_torch.configs.registry``; at full
depth deepseek-v2-236b, jamba-1.5-large-398b, mixtral-8x22b and
llava-next-34b do not fit one card (``chip_smoke.py`` serves the first at
4 of its 60 layers, the second at one block of 8 of its 72 layers with 8
of its 16 experts).  A VLM config (llava-next) prefills zero modal
embeddings before each prompt, where a vision tower would give patch
embeddings, and decodes from the prompt length plus that prefix.

Timing protocol: one prefill and one decode step run before the clock
starts (on the card this also builds and loads the kernels), then prefill
and decode are timed separately, each window closed by
``torch.cuda.synchronize()`` on the card.

After the timed run the driver prints the local device type's
decode-bandwidth efficiency and prefill MFU (``core.calibration``'s
``measured_decode_eff`` and ``measured_prefill_eff``, the JAX driver's
calibration lines); a device off the catalog (the CPU) gets a line that
says so.

``--continuous N`` drives ``ContinuousBatcher`` instead: N requests through
``--batch`` cache slots with admissions between decode steps;
``--disaggregated`` swaps in ``DisaggregatedBatcher``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.core import calibration, memtrace
from repro_torch.core.devices import DEVICE_TYPES
from repro_torch.launch import configure_allocator
from repro_torch.models import init_params
from repro_torch.serve import (ContinuousBatcher, DisaggregatedBatcher,
                               ServeRequest, greedy_decode, prefill,
                               prompt_batch, serve_step)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompt batch (or cache slots with --continuous)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--continuous", type=int, default=0, metavar="N",
                    help="serve N requests through the continuous batcher")
    ap.add_argument("--disaggregated", action="store_true",
                    help="with --continuous: split prefill front-end from"
                         " the decode loop (DisaggregatedBatcher)")
    args = ap.parse_args(argv)
    configure_allocator()

    device = torch.device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    params = init_params(cfg, 0, device=device)
    cache_len = args.prompt_len + cfg.num_modal_tokens + args.gen
    gen = torch.Generator(device=device).manual_seed(1)

    if args.continuous:
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.continuous, args.prompt_len),
                                generator=gen, device=device)
        batcher_cls = (DisaggregatedBatcher if args.disaggregated
                       else ContinuousBatcher)
        greedy_decode(cfg, params, prompts[:1], 2, cache_len)   # warm-up
        cb = batcher_cls(cfg, params, slots=args.batch, cache_len=cache_len)
        _sync(device)
        t0 = time.perf_counter()
        for i in range(args.continuous):
            cb.submit(ServeRequest(i, prompts[i], args.gen))
        out = cb.run()
        _sync(device)
        dt = time.perf_counter() - t0
        n_tok = sum(len(v) for v in out.values())
        mode = "disaggregated" if args.disaggregated else "continuous"
        print(f"arch={cfg.name} device={device} {mode}: {len(out)} requests,"
              f" {n_tok} tokens via {cb.decode_steps} steps x"
              f" {args.batch} slots in {dt:.3f}s ({n_tok / dt:.1f} tok/s)")
        if args.disaggregated:
            print(f"prefill front-end: {cb.prefills} prefills,"
                  f" {cb.handoffs} cache-row handoffs to the decode loop")
        print("sample:", out[0][:12])
        return out

    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    batch = prompt_batch(cfg, params, prompt)
    pos0 = args.prompt_len + cfg.num_modal_tokens   # first decode position
    logits, cache = prefill(cfg, params, batch, cache_len)      # warm-up
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    serve_step(cfg, params, tok, cache, pos0)
    _sync(device)

    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch, cache_len)
    _sync(device)
    dt_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = serve_step(cfg, params, tok, cache, pos0 + i)
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        toks.append(tok)
    _sync(device)
    dt_decode = time.perf_counter() - t0
    toks = torch.cat(toks, dim=1)

    prefill_tok_s = args.batch * args.prompt_len / max(dt_prefill, 1e-9)
    decode_tok_s = args.batch * max(args.gen - 1, 1) / max(dt_decode, 1e-9)
    print(f"arch={cfg.name} device={device} generated {tuple(toks.shape)}:"
          f" prefill {args.batch}x{args.prompt_len} in {dt_prefill:.4f}s"
          f" ({prefill_tok_s:.1f} tok/s), decode {args.gen - 1} steps in"
          f" {dt_decode:.4f}s ({decode_tok_s:.1f} tok/s)")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    dt_name = memtrace.device_type_for(kind)
    if dt_name == memtrace.ANY_DEVICE:
        print(f"calibration: {kind} is off the device catalog; decode-bandwidth"
              f" efficiency and prefill MFU not measured")
    else:
        dev = DEVICE_TYPES[dt_name]
        eff = calibration.measured_decode_eff(decode_tok_s, cfg, args.batch,
                                              cache_len, 1, 1, dev)
        print(f"decode-bandwidth efficiency {eff:.3f} of {dt_name}"
              f" peak (calibration.enable_decode table entry)")
        pf_eff = calibration.measured_prefill_eff(prefill_tok_s, cfg, 1, dev)
        print(f"prefill MFU {pf_eff:.3f} of {dt_name} peak"
              f" (prefill-pool rate model input)")
    print("sample:", toks[0, :12].tolist())
    return toks


if __name__ == "__main__":
    main()
