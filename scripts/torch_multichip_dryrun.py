#!/usr/bin/env python3
"""Dry run of the port's multi-device path: one process a rank over
``torch.distributed``, every rank running the same calls.

    python scripts/torch_multichip_dryrun.py --device cpu              # 8 gloo ranks, dp4 x tp2
    python scripts/torch_multichip_dryrun.py --world 2 --tp 2          # 2 ranks on the card(s)

Each rank builds the tiny random models from one seed, shards them over
the (dp, tp) mesh and runs:

1. ``Qwen3ASR.transcribe_batch`` of two clips a dp row (the dp split: the
   script fails unless each rank staged exactly its rows);
2. one long clip, which a dp mesh routes through the sequence-parallel
   encode;
3. an int4-packed decoder cut over tp (K1 on each rank's shard on the card);
4. a greedy ``PersonaPlex.respond`` cut over tp.

The parent runs the same calls on one device and fails unless every
rank's transcripts and codes equal each other and the one-device run.
Ranks share cards when there are fewer cards than ranks, and then need
gloo (``--backend gloo``, the default when they share), since NCCL takes
one rank a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def clips(n: int):
    rng = np.random.default_rng(0)
    return [(0.1 * rng.standard_normal(16000)).astype(np.float32) for _ in range(n)]


def long_clip():
    return (0.1 * np.random.default_rng(3).standard_normal(10 * 16000)).astype(np.float32)


def run_all(device, mesh, batch: int):
    """The four calls, on ``mesh`` (None: one device). Returns their outputs."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.personaplex import (PersonaPlex, PersonaSampling,
                                                              config_tiny as pp_tiny)
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny

    def shard(model):
        return model.shard(mesh=mesh) if mesh is not None else model

    out = {}
    model = shard(Qwen3ASR.init_random(config_tiny(), 0, device=device, dtype=torch.float32,
                                       audio_buckets_s=(8, 16)))
    out["batch"] = [r.text for r in model.transcribe_batch(clips(batch), max_tokens=4)]
    out["staging"] = dict(model.last_staging)
    out["sp"] = model.transcribe(long_clip(), max_tokens=4).text
    out["sp_staging"] = model.last_staging["sharding"]

    base = config_tiny()
    qcfg = dataclasses.replace(
        base, decoder=dataclasses.replace(base.decoder, hidden_size=128, intermediate_size=256,
                                          num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(base.encoder, output_dim=128))
    qmodel = shard(Qwen3ASR.init_random(qcfg, 0, device=device, dtype=torch.float32,
                                        quant_bits=4, kv_dtype=torch.int8,
                                        audio_buckets_s=(8,)))
    out["int4"] = qmodel.transcribe(clips(1)[0], max_tokens=4).text
    gate = qmodel.decoder_params["layers"][0]["mlp"]
    out["int4_gate_rows"] = (gate["gate_proj"]["codes"].shape[0] if "gate_proj" in gate
                             else gate["gate_up_proj"]["codes"].shape[0] // 2)

    pp = shard(PersonaPlex.init_random(pp_tiny(), device=device))
    audio = (0.1 * np.random.default_rng(1).standard_normal(4800)).astype(np.float32)
    reply = pp.respond(audio, sample_rate=24000, max_extra_s=1.0,
                       sampling=PersonaSampling(text_temperature=0.0, audio_temperature=0.0))
    out["pp_samples"] = reply.samples
    out["pp_text"] = np.asarray(pp.last_text_tokens)
    return out


def rank_main(rank, device, dp, tp, batch):
    import torch

    from qwen3_asr_swift_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp=dp, tp=tp)
    dev = f"cuda:{torch.cuda.current_device()}" if device == "cuda" else "cpu"
    t0 = time.perf_counter()
    out = run_all(dev, mesh, batch)
    out["mesh"] = repr(mesh)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: 8 on the CPU, the cards or 2 on the GPU)")
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    import torch

    from qwen3_asr_swift_tpu_torch.parallel import spawn

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch sees no CUDA device (pass --device cpu for gloo ranks on the CPU)",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    world = args.world or (8 if args.device == "cpu" else max(2, min(cards, 8)))
    if world % args.tp:
        print(f"--tp {args.tp} does not divide --world {world}", file=sys.stderr)
        return 2
    dp, tp = world // args.tp, args.tp
    backend = args.backend or ("nccl" if args.device == "cuda" and cards >= world else "gloo")
    batch = 2 * dp
    print(f"mesh: dp={dp} tp={tp} ranks={world} backend={backend} device={args.device}"
          + (f" ({cards} card(s))" if cards else ""))

    t0 = time.perf_counter()
    ranks = spawn(rank_main, world, args=(args.device, dp, tp, batch), device=args.device,
                  backend=backend, timeout=args.timeout)
    print(f"ranks done in {time.perf_counter() - t0:.1f} s")
    ref = run_all("cuda:0" if args.device == "cuda" else "cpu", None, batch)

    for r, out in enumerate(ranks):
        print(f"rank {r}: {out['mesh']}; staged {out['staging']['per_device_shape']} of "
              f"{out['staging']['batch']} ({out['staging']['sharding']}); "
              f"{out['seconds']:.1f} s")
    for i, text in enumerate(ref["batch"][:4]):
        print(f"slot {i}: {text!r}")
    bad = []
    for r, out in enumerate(ranks):
        if out["staging"]["per_device_shape"][0] != batch // dp:
            bad.append(f"rank {r} staged {out['staging']['per_device_shape'][0]} rows, "
                       f"not {batch // dp}")
        for key in ("batch", "sp", "int4"):
            if out[key] != ref[key]:
                bad.append(f"rank {r} {key}: {out[key]!r} != one device's {ref[key]!r}")
        if not np.array_equal(out["pp_text"], ref["pp_text"]):
            bad.append(f"rank {r} PersonaPlex text tokens differ from one device's")
        err = float(np.abs(out["pp_samples"] - ref["pp_samples"]).max())
        if len(out["pp_samples"]) != len(ref["pp_samples"]) or err > 2e-4:
            bad.append(f"rank {r} PersonaPlex samples {err:.3e} from one device's (tol 2e-4)")
    print(f"dp batch split: {batch} utterances / dp={dp} -> "
          f"{ranks[0]['staging']['per_device_shape'][0]} per rank")
    print(f"sp encode ({ranks[0]['sp_staging']}): {ranks[0]['sp']!r}")
    print(f"int4 tp decode (gate rows {ranks[0]['int4_gate_rows']} a rank): {ranks[0]['int4']!r}")
    print(f"personaplex tp respond: {len(ranks[0]['pp_samples'])} samples, max |rank 0 - one "
          f"device| {float(np.abs(ranks[0]['pp_samples'] - ref['pp_samples']).max()):.3e}")
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    print("torch multichip dryrun OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
