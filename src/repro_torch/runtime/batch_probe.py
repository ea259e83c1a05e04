#!/usr/bin/env python3
"""Peak device memory of the Trainer's steps at a list of batch sizes, as
chip_smoke.py's phase 12 (a) runs them: qwen3-1.7b at full width and
depth, seq 4096, the selection pipeline curating every 2 steps, bf16
compute, no checkpoint; 2 steps a batch.

    PYTHONPATH=src python3 -m repro_torch.runtime.batch_probe 9 10 11
                            (on a machine with a CUDA card)

Prints one line a batch: each step's ms and the peak of
``torch.cuda.max_memory_allocated`` above what was allocated before the
trainer was built, or that the batch ran out of memory.
"""

from __future__ import annotations

import argparse
import gc

import torch

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.trainer import TrainConfig, Trainer


ARCH, SEQ, STEPS, SELECT_EVERY = "qwen3-1.7b", 4096, 2, 2


def peak_at(cfg, batch: int):
    """(step seconds, peak bytes above the start), or None when the card
    runs out of memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = Trainer(cfg, ShapeSpec("probe", SEQ, batch, "train"),
                data=DataConfig(global_batch=batch, seq_len=SEQ,
                                select_every=SELECT_EVERY),
                train=TrainConfig(steps=STEPS), select=True, device="cuda")
    try:
        t.run()
        torch.cuda.synchronize()
        return ([r.seconds for r in t.history],
                torch.cuda.max_memory_allocated() - base)
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        del t
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", type=int, nargs="+")
    args = ap.parse_args(argv)
    cfg = get_config(ARCH)
    for b in args.batches:
        got = peak_at(cfg, b)
        if got is None:
            print(f"[probe] {cfg.name} batch {b} x {SEQ}: out of memory",
                  flush=True)
            continue
        secs, peak = got
        print(f"[probe] {cfg.name} batch {b} x {SEQ}: steps "
              f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms, peak {peak} "
              f"bytes ({peak / 2**30:.2f} GiB)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
