#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:

  1. device   the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds the quorum-tally kernels from csrc/
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes and the kernel tests' shapes: integer
              outputs equal, sum_ms to 1e-5 relative, max_ms equal; median
              CUDA-event times of one call of kernel and plain version, and
              the kernel's device time per call from torch.profiler
  4. masked materializing race   engine.race on the mixed n=12 table at
              8192 samples (the masked_tally path), checked bit-identical
              to the cardinality lowering on the table's cardinality rows
  5. mixed batch   the 13-system n=12 batch through score_systems at 2*10^6
              trials, chunk 8192 (the fused stream kernel's path)
  6. sweep    the 271-system n=11 sweep at 10^7 trials per pass, chunk
              16384, with the sweep's own checks (the tally_decide path)
  profile     40 chunks of each pass of both settings, timed, then traced
              with torch.profiler: the card's busy and idle share and the
              busiest operations
  7. the kernels line: launches on the main paths, error, times, bounds

Launch counts are zeroed just before each main-path phase and read just
after it; launches made to compare a kernel with its plain version do not
count.  Any mismatch or exception exits non-zero before the last line,
which is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/quorum_tally/csrc/quorum_tally.cu"
REPLACES = {
    "tally_decide": "src/repro/kernels/quorum_tally/kernel.py:439",
    "masked_tally": "src/repro/kernels/quorum_tally/kernel.py:138",
    "stream_tally_decide_hist":
        "src/repro/kernels/quorum_tally/kernel.py:321",
}
SWEEP_RACE_CHUNKS = -(-10_000_000 // 16_384)
MIXED_RACE_CHUNKS = -(-2_000_000 // 8_192)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_profile(fn, top: int = 0) -> dict:
    """Run ``fn`` once under torch.profiler: its wall seconds, the seconds
    the card was busy (the device time of every kernel, copy and memset it
    ran), the device seconds by kernel name and, with ``top``, the busiest
    kernels as [name, launches, ms]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU-side op also carries the device time
    # of the kernels it launched, which would count them twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall,
            "device_busy_s": sum(e.self_device_time_total
                                 for e in events) * 1e-6,
            "by_kernel_s": {e.key: e.self_device_time_total * 1e-6
                            for e in events},
            "top": [[e.key[:70], e.count, e.self_device_time_total * 1e-3]
                    for e in events[:top]]}


def mixed_members(n: int = 12):
    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.frontier import families
    return ([families.Member(f"card.{t}", s) for t, s in
             (("headline", QuorumSpec.paper_headline(n)),
              ("fast_paxos", QuorumSpec.fast_paxos(n)),
              ("majority", QuorumSpec.majority_fast(n)))]
            + families.grid_family(n) + families.weighted_family(n))


def stream_test_inputs(seed, S, n, M, G, K, dev):
    """The kernel tests' stream inputs: integral weights, quantized arrival
    times (ties), ~10% lost 2b lanes, trailing padding trials."""
    r = np.random.default_rng(seed)
    votes = r.integers(-1, K, (S, n)).astype(np.int32)
    arrive = np.floor(np.exp(r.standard_normal((S, n))) * 8.0) / 4.0
    classic = np.floor(np.exp(r.standard_normal((S, n))) * 8.0) / 4.0
    val_arr = np.floor(np.exp(r.standard_normal((S, K, n))) * 8.0) / 4.0 + .25
    lost = (votes[:, None, :] != np.arange(K)[None, :, None]) \
        | (r.random((S, K, n)) < 0.1)
    val_arr = np.where(lost, 1e9, val_arr)
    masks = []
    for _ in range(3):
        masks.append(r.integers(0, 3, (M, G, n)).astype(np.float32))
        masks.append(r.integers(1, n + 2, (M, G)).astype(np.float32))
    valid = np.arange(S) < S - S // 7
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    return ([torch.as_tensor(votes).to(dev), f(val_arr), f(arrive),
             f(classic)] + [f(m) for m in masks]
            + [torch.as_tensor(valid).to(dev)])


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.frontier import score_systems
    from repro_torch.frontier.__main__ import (_legacy_fast_p50,
                                               _legacy_recovery_prob,
                                               run_sweep)
    from repro_torch.kernels.quorum_tally import kernel, ops, ref
    from repro_torch.montecarlo import engine, rng, streaming

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    path, log = kernel.build()
    emit("build", seconds=time.perf_counter() - t0,
         library=os.path.relpath(path, ROOT),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    # ---- 3. kernels vs plain versions on the card -------------------------
    stats = {k: {"max_abs_err": 0.0} for k in REPLACES}

    def same(a, b, what):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            fail(f"{what}: {bad} entries differ from the plain version")

    def check_stream(args, kw, what):
        h_k, s_k = kernel.stream_tally_decide_hist(*args, **kw)
        h_r, s_r = ref.stream_tally_decide_hist(*args, **kw)
        same(h_k, h_r, what + " hist")
        for f in ("n_fast", "n_recovery", "n_undecided"):
            same(s_k[f], s_r[f].to(s_k[f].dtype), f"{what} {f}")
        same(s_k["max_ms"], s_r["max_ms"], what + " max_ms")
        num = (s_k["sum_ms"] - s_r["sum_ms"]).abs()
        if bool((num > 1e-5 * s_r["sum_ms"].abs()).any()):
            fail(f"{what} sum_ms off by more than 1e-5 relative")
        err = float(num.max()) if num.numel() else 0.0
        st = stats["stream_tally_decide_hist"]
        st["max_abs_err"] = max(st["max_abs_err"], err)

    n11_gen = rng.generator(rng.root(11), dev)
    offsets = torch.tensor([0.0, 0.2], device=dev)
    raw11 = engine._draw_race(n11_gen, offsets, streaming.default_delay(),
                              n=11, k_proposers=2, samples=16_384)
    v11 = raw11["votes"]
    got = kernel.tally_decide(v11, 2, 7)
    want = ref.tally_decide(v11, 2, 7)
    for a, b, f in zip(got, want, ("counts", "winner", "max", "reached")):
        same(a, b, f"tally_decide (16384, 11) {f}")
    for S, n, q, V in ((100, 11, 7, 2), (2049, 11, 9, 3), (500, 7, 4, 4)):
        g = torch.Generator(device=dev).manual_seed(S + V)
        v = torch.randint(-1, V, (S, n), generator=g, device=dev,
                          dtype=torch.int32)
        for a, b in zip(kernel.tally_decide(v, V, q),
                        ref.tally_decide(v, V, q)):
            same(a, b, f"tally_decide {(S, n, q, V)}")

    from repro_torch.montecarlo.engine import build_mask_table
    table12 = build_mask_table([m.masks(12) for m in mixed_members()],
                               device=dev)
    M12, G2f, _ = table12["p2f_w"].shape
    raw12 = engine._draw_race(rng.generator(rng.root(12), dev), offsets,
                              streaming.default_delay(), n=12,
                              k_proposers=2, samples=8192)
    w_flat = table12["p2f_w"].reshape(M12 * G2f, 12).contiguous()
    t_flat = table12["p2f_t"].reshape(M12 * G2f).contiguous()
    same(kernel.masked_tally(raw12["votes"], w_flat, t_flat, 2),
         ref.masked_tally(raw12["votes"], w_flat, t_flat, 2),
         "masked_tally n=12 fast rows")
    for S, n, V, G in ((257, 9, 2, 1), (1100, 11, 3, 4), (100, 6, 4, 12),
                       (300, 11, 2, 70)):
        r = np.random.default_rng(S * 7 + G)
        v = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32)).to(dev)
        w = torch.as_tensor(r.integers(0, 4, (G, n)).astype(np.float32)
                            ).to(dev)
        t = torch.as_tensor(r.integers(1, n + 2, (G,)).astype(np.float32)
                            ).to(dev)
        same(kernel.masked_tally(v, w, t, V), ref.masked_tally(v, w, t, V),
             f"masked_tally {(S, n, V, G)}")

    k_sat12 = engine.saturation_depths(table12)
    bins = streaming.sketch_bins(0.01)
    valid12 = torch.arange(8192, device=dev) < 8192 - 300
    und = float(engine.UNDECIDED_MS)
    kw12 = dict(n_values=2, precision=0.01, bins=bins, undecided_ms=und)
    args12 = {}
    for rec in ("coordinated", "uncoordinated"):
        raw = engine._draw_race(rng.generator(rng.root(13), dev), offsets,
                                streaming.default_delay(), n=12,
                                k_proposers=2, samples=8192, recovery=rec)
        ph = "p2c" if rec == "coordinated" else "p2f"
        ks = k_sat12 if rec == "coordinated" else (k_sat12[0], k_sat12[2],
                                                   k_sat12[2])
        args12[rec] = ([raw["votes"], raw["val_arr"], raw["arrive"],
                        raw["classic"], table12["p1_w"], table12["p1_t"],
                        table12[ph + "_w"], table12[ph + "_t"],
                        table12["p2f_w"], table12["p2f_t"], valid12],
                       dict(kw12, k_sat=ks))
        check_stream(*args12[rec], f"stream n=12 {rec}")
    for S, n, M, G, K, ks in ((300, 11, 2, 3, 2, (4, 5, 6)),
                              (1025, 9, 1, 6, 3, (9, 9, 9)),
                              (513, 7, 3, 1, 2, (2, 3, 2)),
                              (700, 11, 4, 2, 2, (11, 1, 7))):
        a = stream_test_inputs(S * 13 + M, S, n, M, G, K, dev)
        check_stream(a, dict(n_values=K, k_sat=ks, precision=0.01,
                             bins=bins, undecided_ms=5e8),
                     f"stream {(S, n, M, G, K, ks)}")
    a = stream_test_inputs(3, 128, 5, 1, 2, 2, dev)
    a[-1] = torch.zeros((128,), dtype=torch.bool, device=dev)
    h, s = kernel.stream_tally_decide_hist(
        *a, n_values=2, k_sat=(3, 3, 3), precision=0.01, bins=bins,
        undecided_ms=5e8)
    if int(h.sum()) or int(s["n_fast"].sum()) \
            or not bool(torch.isneginf(s["max_ms"]).all()):
        fail("stream kernel: an all-invalid block contributed")
    torch.cuda.synchronize()

    args_c, kw_c = args12["coordinated"]
    timed = {
        "tally_decide": (lambda: kernel.tally_decide(v11, 2, 0),
                         lambda: ref.tally_decide(v11, 2, 0)),
        "masked_tally": (
            lambda: kernel.masked_tally(raw12["votes"], w_flat, t_flat, 2),
            lambda: ref.masked_tally(raw12["votes"], w_flat, t_flat, 2)),
        "stream_tally_decide_hist": (
            lambda: kernel.stream_tally_decide_hist(*args_c, **kw_c),
            lambda: ref.stream_tally_decide_hist(*args_c, **kw_c)),
    }
    S11, S12 = v11.shape[0], raw12["votes"].shape[0]
    G1, G2c = table12["p1_w"].shape[1], table12["p2c_w"].shape[1]
    mask_bytes = 4 * M12 * 12 * (G1 + G2c + G2f) + 4 * M12 * (G1 + G2c + G2f)
    bytes_ = {
        "tally_decide": S11 * 11 * 4 + S11 * 2 * 4 + S11 * 4 * 2 + S11,
        "masked_tally": (S12 * 12 * 4 + M12 * G2f * 13 * 4
                         + S12 * M12 * G2f * 4),
        "stream_tally_decide_hist": (S12 * 12 * 4 * (1 + 2 + 2) + S12
                                     + mask_bytes + M12 * (bins + 5) * 4),
    }
    # operations: one compare or add per (trial, acceptor, value) of the
    # tallies; the fused kernel adds one pass over each phase's n arrivals
    # per (system, trial), the least a selection can read.
    ops_ = {
        "tally_decide": S11 * 11 * 2,
        "masked_tally": S12 * M12 * G2f * 12 * 2,
        "stream_tally_decide_hist": M12 * S12 * (G2f * 12 * 2 + 3 * 12),
    }
    symbol = {"tally_decide": "tally_decide_kernel",
              "masked_tally": "masked_tally_kernel",
              "stream_tally_decide_hist": "stream_kernel"}
    for k, (kf, pf) in timed.items():
        kms, pms = cuda_ms(kf), cuda_ms(pf)
        reps = 20
        by = device_profile(lambda: [kf() for _ in range(reps)]
                            )["by_kernel_s"]
        dev_ms = sum(s for name, s in by.items()
                     if symbol[k] in name) * 1e3 / reps
        b_ms = bytes_[k] / HBM_BYTES_PER_S * 1e3
        o_ms = ops_[k] / FP32_OPS_PER_S * 1e3
        stats[k].update(ms=kms, plain_ms=pms, device_ms=dev_ms,
                        bound_ms=max(b_ms, o_ms),
                        bound_by="bytes" if b_ms >= o_ms else "operations",
                        bytes=bytes_[k], operations=ops_[k])
    emit("kernels", ok=True, **{k: {kk: vv for kk, vv in v.items()}
                                for k, v in stats.items()})

    # ---- 4. masked materializing race (masked_tally) ----------------------
    ops.reset_launches()
    out = engine.race(rng.root(4), table12, [0.0, 0.2], n=12, k_proposers=2,
                      samples=8192)
    torch.cuda.synchronize()
    launches4 = dict(ops.LAUNCHES)
    if launches4 != {"tally_decide": 0, "masked_tally": 1,
                     "stream_tally_decide_hist": 0}:
        fail(f"masked race launches {launches4}")
    lat = out["latency_ms"]
    if tuple(lat.shape) != (M12, 8192):
        fail(f"masked race latency shape {tuple(lat.shape)}")
    dec = ~out["undecided"]
    if not bool(torch.isfinite(lat[dec]).all()) or not bool(dec.any()):
        fail("masked race: decided latencies not finite")
    card = build_mask_table([m.masks(12) for m in mixed_members()[:3]],
                            device=dev)
    out_q = engine.race(rng.root(4), card, [0.0, 0.2], n=12, k_proposers=2,
                        samples=8192)
    for f in out_q:
        same(out[f][:3], out_q[f], f"masked vs cardinality lowering {f}")
    emit("masked_race", ok=True, launches=launches4,
         fast_rate=out["reached_fast"].float().mean(1).tolist())

    # ---- 5. mixed n=12 batch (stream_tally_decide_hist) --------------------
    members = mixed_members()
    ops.reset_launches()
    fr = score_systems(members, n=12, trials=2_000_000, chunk=8192, seed=0)
    torch.cuda.synchronize()
    launches5 = dict(ops.LAUNCHES)
    if launches5 != {"tally_decide": 0, "masked_tally": 0,
                     "stream_tally_decide_hist": MIXED_RACE_CHUNKS}:
        fail(f"mixed batch launches {launches5}")
    race, fast = fr.streams["race"], fr.streams["fast"]
    for s in (race, fast):
        if not bool((s.n_trials == 2_000_000).all()):
            fail("mixed batch: trial counts")
        if not torch.equal(s.hist.sum(1, dtype=torch.int32), s.n_decided):
            fail("mixed batch: histogram mass != decided count")
    if not np.isfinite(np.asarray(fr.values)[:, :2]).all():
        fail("mixed batch: non-finite latency axes")
    check = rng.root(5)
    for i in range(3):                   # the cardinality landmarks
        spec, row = members[i].system, fr.row(i)
        p50 = _legacy_fast_p50(rng.generator(rng.derive(check, 0, i), dev),
                               12, spec.q2f, 50_000)
        prec = _legacy_recovery_prob(
            rng.generator(rng.derive(check, 0, 100 + i), dev), spec, 0.2,
            50_000)
        if abs(p50 - row["fast_p50_ms"]) >= 0.05 \
                or abs(prec - row["p_recovery"]) >= 4.5 * (0.5 / 5e4) ** .5:
            fail(f"mixed batch {fr.labels[i]}: {row} vs per-spec "
                 f"p50 {p50}, P(recovery) {prec}")
    emit("mixed_batch", ok=True, systems=len(members), trials=2_000_000,
         launches=launches5,
         race_trials_per_sec=2_000_000 / fr.wall_s["race"],
         fast_trials_per_sec=2_000_000 / fr.wall_s["fast"],
         frontier=list(fr.frontier_labels))

    # ---- 6. the n=11 sweep (tally_decide) ----------------------------------
    ops.reset_launches()
    sw = run_sweep(quick=False, device=dev)
    torch.cuda.synchronize()
    launches6 = dict(ops.LAUNCHES)
    if launches6 != {"tally_decide": SWEEP_RACE_CHUNKS, "masked_tally": 0,
                     "stream_tally_decide_hist": 0}:
        fail(f"sweep launches {launches6}")
    res = sw["result"]
    with open(os.path.join(ROOT, "BENCH_baseline.json")) as fh:
        metrics = json.load(fh).get("metrics", {})
    baseline = sorted({k.split("]")[0][len("sweep.["):] + "]"
                       for k in metrics if k.startswith("sweep.[")})
    emit("sweep", ok=True, systems=len(res.labels), trials=sw["trials"],
         launches=launches6,
         fast_trials_per_sec=sw["trials"] / res.wall_s["fast"],
         race_trials_per_sec=sw["trials"] / res.wall_s["race"],
         frontier_size=len(res.frontier_indices),
         frontier=list(res.frontier_labels),
         jax_cpu_frontier_for_reference=baseline)

    # ---- where the time goes: 40 chunks of each pass of each setting ------
    from repro_torch.frontier import cardinality_family
    table11 = build_mask_table([m.masks() for m in cardinality_family(11)],
                               device=dev)
    windows = {}
    for cell, table, n, chunk in (("sweep_n11", table11, 11, 16_384),
                                  ("mixed_n12", table12, 12, 8_192)):
        for p in ("fast", "race"):
            if p == "race":
                fn = lambda: streaming.race_stream(
                    rng.root(6), table, offsets, n=n, k_proposers=2,
                    trials=40 * chunk, chunk=chunk)
            else:
                fn = lambda: streaming.fast_path_stream(
                    rng.root(6), table, n=n, trials=40 * chunk, chunk=chunk)
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof = device_profile(fn, top=6)
            windows[f"{cell}.{p}"] = dict(
                chunks=40, wall_s=wall,
                device_busy_s=prof["device_busy_s"],
                idle_share=1.0 - prof["device_busy_s"] / wall,
                profiled_wall_s=prof["wall_s"], top_ms=prof["top"])
    emit("profile", **windows)

    # ---- 7. kernels line ---------------------------------------------------
    launches = {"tally_decide": launches6["tally_decide"],
                "masked_tally": launches4["masked_tally"],
                "stream_tally_decide_hist":
                    launches5["stream_tally_decide_hist"]}
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"], "bound_ms": stats[k]["bound_ms"],
         "bound_by": stats[k]["bound_by"], "library_ms": None}
        for k in REPLACES]}
    if any(k["launches"] <= 0 for k in line["kernels"]):
        fail(f"a kernel was not launched on its path: {launches}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
