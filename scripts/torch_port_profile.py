"""Where the time of the PyTorch port's main paths goes, on one NVIDIA GPU.

    python3 scripts/torch_port_profile.py [--chunks 1]

For the DQN-on-pixels pipeline of ``bench.py`` and then for the Rainbow +
prioritized-replay pipeline (``chip_smoke.build_pipeline``: 256 envs,
512-slot uint8 rings, batch 32, update_per_step 0.1, T=16), in
``tianshou_tpu_torch`` at full width: warms the pipeline up with a random
prefill and one training chunk, times ``--chunks`` chunks (collect 16 steps
+ 410 updates each) without the profiler, then traces as many more with
``torch.profiler``. Prints both wall times, the device's busy time from the
trace (the sum of its kernels' times; one stream, so they do not overlap),
the idle share against the unprofiled wall time (and, apart, against the
traced one, which the profiler's host overhead inflates), kernel launches
per update, and the kernels that take the most device time, with the card's
name and power limit.

For the prioritized replay it then traces its parts alone, 50 calls each at
the main path's shapes, and prints the kernel launches and device time per
call of the stratified sampler, the weights, the priority writeback (a tree
update of 32 leaves) and the collector's max-priority write (256 leaves), so
that their share of an update's launches can be read off.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def _device_events(prof) -> dict[str, list[float]]:
    """Device-side kernel times by name, less the user annotations that mirror CPU ops on the
    device timeline (e.g. "Optimizer.step#Adam.step"), which span kernels counted on their own."""
    import torch

    per_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            per_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return per_name


def profile_path(kind: str, chunks: int, smi: str):
    """Time and trace ``chunks`` update chunks of the pipeline of ``kind``; returns its buffer,
    buffer state and generator for the traces of the parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    E, T, batch = chip_smoke.E, chip_smoke.T, chip_smoke.BATCH
    algo, ts, buffer, buf_state, coll = chip_smoke.build_pipeline(torch, kind)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def trainer(n: int, prefill: bool) -> OffPolicyTrainer:
        params = OffPolicyTrainerParams(
            max_epochs=1, epoch_num_steps=n * T * E, batch_size=batch,
            collection_step_num_env_steps=T, update_per_step=0.1,
            start_steps=T * E if prefill else 0, verbose=False,
        )
        return OffPolicyTrainer(algo, coll, None, buffer, params)

    res = trainer(1, prefill=True).run(ts, buf_state, gen)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer(chunks, prefill=False).run(res.train_state, res.buf_state, gen)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_timing = dict(res.timing)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = trainer(chunks, prefill=False).run(res.train_state, res.buf_state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = _device_events(prof)
    busy_us = sum(sum(v) for v in per_name.values())
    launches = sum(len(v) for v in per_name.values())
    updates = res.gradient_step
    print(f"== {kind} path ==")
    print(f"device: {smi}")
    print(f"profiled {chunks} chunk(s): {chunks * T * E} env steps, {updates} updates")
    print(f"wall ms without the profiler {plain_wall * 1e3:.1f} (collect {plain_timing['collect'] * 1e3:.1f}, "
          f"update {plain_timing['update'] * 1e3:.1f} = {plain_timing['update'] / max(updates, 1) * 1e3:.3f} per update)")
    print(f"wall ms under the profiler {wall * 1e3:.1f} (collect {res.timing['collect'] * 1e3:.1f}, "
          f"update {res.timing['update'] * 1e3:.1f})")
    print(f"device busy ms {busy_us / 1e3:.1f}, idle share {1 - busy_us / 1e3 / (plain_wall * 1e3):.3f} "
          f"against the wall time without the profiler ({1 - busy_us / 1e3 / (wall * 1e3):.3f} under it), "
          f"kernel launches {launches} ({launches / max(updates, 1):.1f} per update incl. collect)")
    print("top kernels by device time: total_ms, calls, mean_us, name")
    for name, v in sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:15]:
        print(f"  {sum(v) / 1e3:9.2f} {len(v):7d} {sum(v) / len(v):9.2f}  {name[:110]}")
    return buffer, res.buf_state, gen


def profile_per_parts(buffer, state, gen, smi: str, calls: int = 50) -> None:
    """Kernel launches and device time per call of each part of the prioritized replay, at the
    main path's shapes (a tree of 131072 leaves, batch 32, 256 envs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch, E = chip_smoke.BATCH, chip_smoke.E
    idx = buffer.sample_indices(state, gen, batch)
    td = torch.rand(batch, device="cuda", generator=gen)
    new = torch.randint(0, buffer.total_size, (E,), device="cuda", generator=gen)
    prio = torch.ones(E, device="cuda")
    parts = {
        "sample_indices (uniforms, strata, sum-tree kernel)": lambda: buffer.sample_indices(state, gen, batch),
        "get_weight": lambda: buffer.get_weight(state, idx),
        f"update_weight (tree update of {batch} leaves)": lambda: buffer.update_weight(state, idx, td),
        f"segtree.update of {E} leaves (the collector's add)": lambda: buffer.segtree.update(state.tree, new, prio),
    }
    print(f"== parts of the prioritized replay, {calls} calls each [{smi}] ==")
    print("part: kernel launches per call, device us per call, wall us per call")
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / calls * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per_name = _device_events(prof)
        n = sum(len(v) for v in per_name.values())
        print(f"  {name}: {n / calls:.1f} launches, {sum(sum(v) for v in per_name.values()) / calls:.1f} us device, "
              f"{wall_us:.1f} us wall (without the profiler)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_port_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke._smi()
    profile_path("dqn", args.chunks, smi)
    buffer, state, gen = profile_path("rainbow", args.chunks, smi)
    profile_per_parts(buffer, state, gen, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
