"""Where serving's time goes: prefill and greedy decode under ``torch.profiler``
on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [--arch recurrentgemma-9b|falcon-mamba-7b|qwen2-moe-a2.7b|...] \\
        [--batch 4] [--prompt_len 4096] [--steps 8] [--out trace_prefix]

Builds the serve launcher's run at full width (random params from the seed,
``use_pallas=True``, an f32 decode cache), warms up with one prefill and two
decode steps, then profiles one prefill and, separately, ``--steps`` decode
steps.  As the launcher, a vlm's cache also holds its prefix and its steps
start after it, and whisper's "prefill" is its encoder and cross K/V
(``init_decode_state``: the launcher prefills no decoder), its steps starting
from the first prompt token at position 0.  For each it prints the wall time, the device-busy share (summed
device-op time over wall time; ops on one stream do not overlap), the device
ops, the kernels that took the most device time and the host ops that took
the most CPU time.  ``--out`` also writes ``<out>_prefill.json`` and
``<out>_decode.json`` Chrome traces.  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch.profile_tick import print_profile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="recurrentgemma-9b", choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--out", default=None, help="prefix of the Chrome traces")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_for
    from repro_torch.models import model as M
    from repro_torch.training import init_params, make_serve_step

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    cfg = dataclasses.replace(get_config(args.arch), use_pallas=True)
    params = init_params(0, cfg, "cuda")
    batch = make_batch_for(cfg, batch=args.batch, seq=args.prompt_len, seed=0, device="cuda")
    n_prefix = cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0
    capacity = n_prefix + args.prompt_len + 2 + args.steps
    step = make_serve_step(cfg)

    def prefill():
        if cfg.is_encoder_decoder:
            cache = M.init_decode_state(params, cfg, args.batch, capacity,
                                        cache_dtype=torch.float32, batch=batch)
            return batch["tokens"][:, 0].to(torch.int32), cache, 0
        logits, cache = M.prefill(params, batch, cfg, capacity, cache_dtype=torch.float32)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache, n_prefix + args.prompt_len

    def decode(cache, token, start, n):
        for i in range(n):
            out = step(params, cache, token, start + i)
            token, cache = out["next_token"], out["cache"]
        return cache, token

    token, cache, start = prefill()
    start = torch.tensor(start, device="cuda")
    cache, token = decode(cache, token, start, 2)
    torch.cuda.synchronize()
    print(f"arch={cfg.name} layers={cfg.num_layers} batch={args.batch} "
          f"prompt={args.prompt_len} card={torch.cuda.get_device_name(0)}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print("-- prefill")
    print_profile(prof, wall, 1, "prefill", args.top)
    if args.out:
        prof.export_chrome_trace(f"{args.out}_prefill.json")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(cache, token, start + 2, args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"-- decode ({args.steps} steps)")
    print_profile(prof, wall, args.steps, "step", args.top)
    if args.out:
        prof.export_chrome_trace(f"{args.out}_decode.json")


if __name__ == "__main__":
    main()
