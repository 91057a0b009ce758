"""Drive the socket serving host with many concurrent clients.

    python -m ddsp_tpu_torch.utils.server_drive [--clients=16] [--slots=32]
        [--hops=12] [--sessions=2] [--device=cuda]

The port of ``scripts/server_drive.py``.  Starts a ``runtime.server.
StreamServer`` at the full default ``Config()`` width with seeded random
weights on a unix socket, then runs ``clients`` concurrent clients, each
streaming ``sessions`` sessions of ``hops`` blocks of a tone, one
connection a session: every disconnect frees a slot that a later session
takes again.  A client that finds every slot taken tries again.  Every
session's blocks must come back finite and in order, and a session that
reuses a slot must start from a fresh state (``runtime/multistream.
reset_slots``): each session's output is held against its slot in a fresh
``MultiStreamServer`` fed the same blocks, within 1e-5 (the serving
tests' criterion), and a difference is an error.  What it exercises is
the host machinery (accept, mailboxes, masked steps, flushes, resets)
under real concurrency, not latency.

Prints one JSON line with ``scripts/server_drive.py``'s keys
(``sessions_completed``, ``all_finite_in_order``, ``distinct_slots_used``,
``errors``, ``aggregate_hops_per_s`` ...) and ``sessions_on_reused_slots``,
``fresh_slot_max_abs_err``, ``device_steps`` (the serving steps and flushes
run, the fresh servers' included: each launches the slot oscillator once),
``device_flushes`` (the flushes among them, which run no controller step)
and the card; exits 1 on any error or missing session.  Runs on CUDA unless ``--device=cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

FRESH_ATOL = 1e-5  # a socket client vs its slot (tests/test_torch_serving.py)


def drive(params, crepe, conf, clients: int = 16, slots: int = 32, hops: int = 12,
          sessions: int = 2, device="cuda", seed: int = 0, timeout: float = 600.0) -> dict:
    """Run the drive described above; returns its JSON object."""
    from ddsp_tpu_torch.device import resolve_device
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer
    from ddsp_tpu_torch.runtime.server import StreamServer, stream_blocks

    device = resolve_device(device)
    hop = conf.hop_length
    address = os.path.join(tempfile.mkdtemp(), "drive.sock")
    srv = StreamServer(params, crepe, conf, address, n_streams=slots, noise_seed=seed,
                       device=device).start()
    results, errors, lock = [], [], threading.Lock()

    def client(cid: int) -> None:
        rng = np.random.default_rng(100 + cid)
        for session in range(sessions):
            t = np.arange(hops * hop) / conf.sample_rate
            f = rng.uniform(150, 400)
            blocks = (0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32).reshape(hops, hop)
            give_up = time.monotonic() + timeout
            while True:
                started = time.monotonic()  # accepted in connect order: a slot's sessions in turn
                try:
                    out, slot = stream_blocks(address, blocks, timeout=timeout)
                    break
                except ConnectionError as e:
                    if str(e) == "server full" and time.monotonic() < give_up:
                        time.sleep(0.01)  # every slot taken: wait for a disconnect
                        continue
                    with lock:
                        errors.append((cid, session, repr(e)))
                    return
                except Exception as e:  # noqa: BLE001 -- recorded and reported below
                    with lock:
                        errors.append((cid, session, repr(e)))
                    return
            ok = out.shape == (hops + 1, hop) and bool(np.isfinite(out).all())
            with lock:
                results.append(dict(cid=cid, session=session, slot=slot, ok=ok, blocks=blocks,
                                    out=out, started=started))

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout * sessions)
    finally:
        srv.close()
    wall = time.time() - t0
    steps, flushes = srv.steps, srv.flushes
    errors += [(c, None, "client hung") for c, t in enumerate(threads) if t.is_alive()]

    # the k-th session on each slot, against that slot of a fresh server
    by_slot = {}
    for r in sorted(results, key=lambda r: r["started"]):
        by_slot.setdefault(r["slot"], []).append(r)
    worst = 0.0
    for k in range(max((len(v) for v in by_slot.values()), default=0)):
        round_k = {s: v[k] for s, v in by_slot.items() if len(v) > k and v[k]["ok"]}
        feed = np.zeros((hops, slots, hop), np.float32)
        for s, r in round_k.items():
            feed[:, s] = r["blocks"]
        ref = MultiStreamServer(params, crepe, conf, slots, noise_seed=seed, device=device)
        want = np.stack([ref.process(b) for b in feed] + [ref.flush()], axis=1)
        steps += 1 + hops + 1  # its warm-up step, the hops, the flush
        flushes += 1
        for s, r in round_k.items():
            err = float(np.abs(r["out"] - want[s]).max())
            worst = max(worst, err)
            if err > FRESH_ATOL:
                errors.append((r["cid"], r["session"], f"slot {s}, its session {k + 1}: "
                               f"{err:.3e} from a fresh slot"))

    delivered = sum(hops + 1 for r in results if r["ok"])
    return {
        "clients": clients,
        "slots": slots,
        "sessions_completed": len(results),
        "sessions_expected": clients * sessions,
        "all_finite_in_order": all(r["ok"] for r in results),
        "distinct_slots_used": len(by_slot),
        "errors": errors,
        "wall_s": wall,
        "aggregate_hops_per_s": delivered / wall,
        "sessions_on_reused_slots": sum(len(v) - 1 for v in by_slot.values()),
        "fresh_slot_max_abs_err": worst,
        "device_steps": steps,
        "device_flushes": flushes,
    }


def failed(result: dict) -> bool:
    """An error, or a session that did not complete."""
    return bool(result["errors"]) or result["sessions_completed"] != result["sessions_expected"]


def main(argv=None) -> int:
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.device import resolve_device
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.utils.profiling import card_name

    args = dict(a[2:].split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.get("device", "cuda"))
    conf = Config()
    result = drive(decoder_init(conf, seed=0), crepe_init(conf.crepe_capacity, seed=1), conf,
                   clients=int(args.get("clients", "16")), slots=int(args.get("slots", "32")),
                   hops=int(args.get("hops", "12")), sessions=int(args.get("sessions", "2")),
                   device=device)
    result["card"] = card_name(device)
    print(json.dumps(result), flush=True)
    return 1 if failed(result) else 0


if __name__ == "__main__":
    sys.exit(main())
