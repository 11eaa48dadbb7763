"""Serving launcher of the port (the counterpart of ``repro.launch.serve``):
prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
        --batch 4 --prompt_len 4096 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --batch 4 --prompt_len 4096 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Runs on the card by default, and there with ``use_pallas=True``: the
attention of every local or global layer runs the hand-written flash kernel,
every RG-LRU layer the hand-written RG-LRU kernel and every Mamba layer the
hand-written selective-scan kernel, the counterpart of the reference's TPU
fast path.  Decode runs none of them: its step is plain PyTorch, as the
reference's is plain jnp.  ``--device cpu`` keeps the config's value (the
plain PyTorch path).  Params are random, drawn from ``--seed``; the decode
cache is f32, as the reference launcher's.  Prints the prefill and decode
times, tok/s and the ids generated for the first prompt; ``--json PATH``
also writes them as the reference's three bench.v1 rows
(:mod:`repro_torch.bench_schema`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.models import model as M
from repro_torch.training import init_params, make_serve_step


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, batch: dict, *, gen: int, cache_dtype=torch.float32) -> dict:
    """Prefill ``batch["tokens"]`` (B, S), then ``gen`` batched greedy steps.

    Returns the prefill's last logits (B, V), the decode steps' logits
    (B, gen, V), the generated ids (B, gen) and the host-clock times of the
    prefill and the decode (each ending in a device synchronize).
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits, cache = M.prefill(params, batch, cfg, S + gen, cache_dtype=cache_dtype)
    last = torch.argmax(prefill_logits, dim=-1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    step = make_serve_step(cfg)
    start = torch.tensor(S, device=dev)  # positions stay on the device: no sync per step
    ids, logits = [], []
    t0 = time.perf_counter()
    for i in range(gen):
        out = step(params, cache, last, start + i)
        last, cache = out["next_token"], out["cache"]
        ids.append(last)
        logits.append(out["logits"])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "prefill_logits": prefill_logits,
        "logits": torch.stack(logits, dim=1) if logits else None,
        "tokens": torch.stack(ids, dim=1) if ids else None,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": gen * B / t_decode if gen else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", help="small same-family variant")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write timings as bench.v1 rows to PATH")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = torch.device(args.device)
    if device.type == "cuda":
        cfg = dataclasses.replace(cfg, use_pallas=True)
    params = init_params(args.seed, cfg, device)
    batch = make_batch_for(cfg, batch=args.batch, seq=args.prompt_len, seed=args.seed,
                           device=device)
    result = serve(cfg, params, batch, gen=args.gen)
    print(f"arch={cfg.name} layers={cfg.num_layers} device={device} use_pallas={cfg.use_pallas}")
    print(f"prefill: {result['prefill_s']:.2f}s")
    if args.gen:
        print(f"decode: {args.gen} steps x batch {args.batch} in {result['decode_s']:.2f}s "
              f"({result['tok_per_s']:.1f} tok/s)")
        print("generated token ids [0]:", result["tokens"][0].tolist())
    if args.json:
        from repro_torch.bench_schema import bench_row, write_bench_json

        config = {"arch": args.arch, "batch": args.batch, "prompt_len": args.prompt_len,
                  "gen": args.gen, "reduced": args.reduced, "seed": args.seed}
        base = f"serve/{args.arch}"
        write_bench_json(args.json, [
            bench_row(f"{base}/prefill_s", result["prefill_s"], "s", config),
            bench_row(f"{base}/decode_s", result["decode_s"], "s", config),
            bench_row(f"{base}/tok_per_s", result["tok_per_s"] or 0.0, "tok/s", config),
        ])
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
