"""Network serving host: N real-time synth clients over one device step.

Counterpart of ``ddsp_tpu/runtime/server.py``, with the same wire
protocol.  Up to ``n_streams`` concurrent socket clients are multiplexed
into the slots of the multi-stream step (runtime/multistream.py).  Clients
are asynchronous: whichever slots have a block pending are stepped
together (``make_multistream_step(masked=True)`` freezes the other rows
exactly), so every client sees lockstep single-stream semantics however
its blocks interleave with other clients'.

Wire protocol (little-endian, one stream per connection):

* on accept the server sends a 14-byte header
  ``magic(4s) sample_rate(u32) hop(u32) slot(u16)`` -- magic ``b"DSPT"``,
  or ``b"FULL"`` (then close) when every slot is taken;
* the client repeatedly sends one block of ``hop`` float32 mono samples and
  reads back one block of ``hop`` float32 synthesized samples;
* the client half-closes (``shutdown(SHUT_WR)``) to finish; the server
  replies with one final tail block (the flush of the last buffered frame)
  and closes, freeing the slot for the next client.

Run a host on the GPU from the port's own training checkpoints (the
newest ``step_*`` under ``--checkpoint_dir``) or a Lightning file:
``python -m ddsp_tpu_torch.runtime.server --checkpoint_dir=ckpt
--crepe_checkpoint=tiny.pth --listen=0.0.0.0:9600``
(or ``--lightning_ckpt=decoder.ckpt``).
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import Crepe
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.runtime.multistream import (
    make_multistream_flush,
    make_multistream_step,
    multistream_init,
    reset_slots,
)

MAGIC = b"DSPT"
HEADER = struct.Struct("<4sIIH")

Address = Union[str, Tuple[str, int]]


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF (or EOF mid-message)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class _Slot:
    """Mailbox pair between one client thread and the engine thread.

    The protocol is lockstep per client (one outstanding block), so a
    single input cell and output cell with an event each suffice.
    """

    def __init__(self):
        self.inp: Optional[np.ndarray] = None
        self.out: Optional[np.ndarray] = None
        self.seq = 0  # bumped per real delivery: freshness, not _stop, decides
        self.out_ready = threading.Event()
        self.flush_req = False
        self.reset_req = False  # applied by the engine before the next step
        self.active = False  # owned by a connected client
        self.gen = 0  # bumped per owner: stale engine deliveries are dropped


class StreamServer:
    """Serve ``n_streams`` concurrent synth clients on ``address``.

    ``address``: a filesystem path (AF_UNIX) or a ``(host, port)`` tuple.
    All device work happens on one engine thread; client threads only move
    bytes.  Start with :meth:`start`, stop with :meth:`close`.  Runs on
    CUDA unless ``device="cpu"``; the modules are moved to the device in
    place.
    """

    def __init__(
        self,
        params: Decoder,
        crepe_params: Crepe,
        conf: Config,
        address: Address,
        n_streams: int = 16,
        noise_seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.conf = conf
        self.hop = conf.hop_length
        self.n_streams = n_streams
        self.address = address
        params = params.to(self.device).eval()
        crepe_params = crepe_params.to(self.device).eval()
        key = PRNGKey(noise_seed, self.device)
        self._step = make_multistream_step(
            params, crepe_params, conf, key, masked=True
        )
        self._flush = make_multistream_flush(params, conf, key)
        self._state = multistream_init(conf, n_streams, self.device)
        self._slots = [_Slot() for _ in range(n_streams)]
        self._lock = threading.Lock()  # guards slot ownership + mailboxes
        self._work = threading.Event()  # "engine: something is pending"
        self._stop = threading.Event()
        self._threads = []
        self._listener: Optional[socket.socket] = None
        # build the kernel and pick library algorithms before the first
        # deadline-bound client block; nothing is committed
        self._step(
            self._state,
            torch.zeros((n_streams, self.hop), device=self.device),
            torch.zeros((n_streams,), dtype=torch.bool, device=self.device),
        )
        self.steps = 1  # device steps run: this one, then every step and flush
        self.flushes = 0  # of them, the flushes: tail renders, no controller step

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "StreamServer":
        if isinstance(self.address, str):
            if os.path.exists(self.address):
                os.unlink(self.address)
            self._listener = socket.socket(socket.AF_UNIX)
        else:
            self._listener = socket.socket(socket.AF_INET)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(self.address)
        self._listener.listen(self.n_streams)
        self._listener.settimeout(0.2)
        for target in (self._accept_loop, self._engine_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self) -> None:
        self._stop.set()
        self._work.set()
        for s in self._slots:  # release any client blocked on its mailbox
            s.out_ready.set()
        for t in self._threads:  # acceptor + engine only; clients are daemons
            t.join(timeout=5)
        if self._listener is not None:
            self._listener.close()
        if isinstance(self.address, str) and os.path.exists(self.address):
            os.unlink(self.address)

    # ------------------------------------------------------------- accepting

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            slot_id = self._take_slot()
            if slot_id is None:
                try:
                    conn.sendall(HEADER.pack(b"FULL", 0, 0, 0))
                finally:
                    conn.close()
                continue
            threading.Thread(
                target=self._client_loop, args=(conn, slot_id), daemon=True
            ).start()

    def _take_slot(self) -> Optional[int]:
        with self._lock:
            for i, s in enumerate(self._slots):
                if not s.active:
                    s.active = True
                    s.gen += 1
                    s.inp = None
                    s.out = None
                    s.flush_req = False
                    s.out_ready.clear()
                    return i
        return None

    # --------------------------------------------------------------- clients

    def _await_output(self, slot: _Slot) -> bool:
        # freshness (the per-delivery seq), not _stop, decides: a block the
        # engine delivered just before shutdown still reaches its client
        start_seq = slot.seq
        while True:
            if slot.out_ready.wait(timeout=0.5):
                slot.out_ready.clear()
                if slot.seq != start_seq and slot.out is not None:
                    return True
                # a shutdown/engine-failure wakeup carries no data
                if self._stop.is_set():
                    return False
            elif self._stop.is_set():
                return False

    def _client_loop(self, conn: socket.socket, slot_id: int) -> None:
        slot = self._slots[slot_id]
        n_blocks = 0
        try:
            conn.sendall(
                HEADER.pack(MAGIC, self.conf.sample_rate, self.hop, slot_id)
            )
            while not self._stop.is_set():
                raw = _recv_exact(conn, self.hop * 4)
                if raw is None:
                    break  # client finished (half-close or disconnect)
                block = np.frombuffer(raw, "<f4")
                with self._lock:
                    slot.inp = block
                self._work.set()
                if not self._await_output(slot):
                    return
                conn.sendall(np.ascontiguousarray(slot.out, "<f4").tobytes())
                n_blocks += 1
            if n_blocks and not self._stop.is_set():
                with self._lock:
                    slot.flush_req = True
                self._work.set()
                if not self._await_output(slot):
                    return
                conn.sendall(np.ascontiguousarray(slot.out, "<f4").tobytes())
        except OSError:
            pass  # client went away mid-write; slot is reset below
        finally:
            conn.close()
            with self._lock:
                # the engine (sole owner of device state) applies the reset
                # before its next step; _take_slot hands the slot out again
                # only after active=False below
                slot.reset_req = True
                slot.inp = None
                slot.flush_req = False
                slot.active = False
            self._work.set()

    # ---------------------------------------------------------------- engine

    def _engine_loop(self) -> None:
        """Sole owner of the device state.  Each iteration: apply slot
        resets queued by disconnects, gather at most one pending block per
        slot, run one masked step for the slots with input, then serve
        flush requests (a tail render that reads state without committing
        it).  A device failure stops the server, so clients waiting in
        _await_output disconnect instead of hanging on a dead engine."""
        try:
            self._engine_iterations()
        except Exception as e:  # noqa: BLE001 -- the engine's boundary
            print(
                f"ddsp_tpu_torch server: engine failed, shutting down: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
                flush=True,
            )
            self._stop.set()
            for s in self._slots:
                s.out_ready.set()

    def _engine_iterations(self) -> None:
        zeros = np.zeros((self.hop,), np.float32)
        while not self._stop.is_set():
            self._work.wait(timeout=0.2)
            self._work.clear()
            if self._stop.is_set():
                return
            with self._lock:
                resets = [i for i, s in enumerate(self._slots) if s.reset_req]
                for i in resets:
                    self._slots[i].reset_req = False
                mask = np.array([s.inp is not None for s in self._slots], bool)
                blocks = np.stack(
                    [s.inp if s.inp is not None else zeros for s in self._slots]
                )
                flushes = [i for i, s in enumerate(self._slots) if s.flush_req]
                gens = [s.gen for s in self._slots]
                for s in self._slots:
                    s.inp = None
                    s.flush_req = False

            def deliver(i, row):
                with self._lock:
                    if self._slots[i].gen == gens[i]:  # owner unchanged
                        self._slots[i].out = row
                        self._slots[i].seq += 1
                        self._slots[i].out_ready.set()

            if flushes:
                tail = self._flush(self._state)[0].cpu().numpy()
                self.steps += 1
                self.flushes += 1
                for i in flushes:
                    deliver(i, tail[i])
            if resets:
                self._state = reset_slots(self.conf, self._state, resets)
            if mask.any():
                out, self._state = self._step(
                    self._state,
                    torch.from_numpy(blocks).to(self.device),
                    torch.from_numpy(mask).to(self.device),
                )
                out = out.cpu().numpy()
                self.steps += 1
                for i in np.nonzero(mask)[0]:
                    deliver(i, out[i])


# ------------------------------------------------------------------ client


def stream_blocks(
    address: Address, blocks: np.ndarray, timeout: Optional[float] = 120.0
) -> Tuple[np.ndarray, int]:
    """Lockstep client: send (n, hop) blocks, return ((n+1, hop) outputs
    including the flush tail, slot_id).  Raises ConnectionError when the
    server is full, socket.timeout when the host stops responding for
    ``timeout`` seconds."""
    sock = socket.socket(
        socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    )
    try:
        sock.settimeout(timeout)
        sock.connect(address)
        hdr = _recv_exact(sock, HEADER.size)
        if hdr is None:
            raise ConnectionError("server closed during handshake")
        magic, _rate, hop, slot_id = HEADER.unpack(hdr)
        if magic != MAGIC:
            raise ConnectionError("server full")
        if blocks.shape[1] != hop:
            raise ValueError(f"blocks of {blocks.shape[1]} samples, server hop {hop}")
        outs = []
        for b in np.asarray(blocks, np.float32):
            sock.sendall(np.ascontiguousarray(b, "<f4").tobytes())
            raw = _recv_exact(sock, hop * 4)
            if raw is None:
                raise ConnectionError("server closed mid-stream")
            outs.append(np.frombuffer(raw, "<f4"))
        sock.shutdown(socket.SHUT_WR)
        raw = _recv_exact(sock, hop * 4)
        if raw is None:
            raise ConnectionError("server closed before the flush tail")
        outs.append(np.frombuffer(raw, "<f4"))
        return np.stack(outs), slot_id
    finally:
        sock.close()


def stream_file(
    address: Address,
    in_path: str,
    out_path: str = "",
    timeout: Optional[float] = 120.0,
) -> np.ndarray:
    """Stream a whole WAV file through a serving host.  Returns the
    synthesized mono audio (and writes ``out_path`` when given)."""
    from ddsp_tpu_torch.data.audio_io import read_audio, write_wav
    from ddsp_tpu_torch.ops.resample import resample

    sock = socket.socket(
        socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    )
    try:
        sock.settimeout(timeout)
        sock.connect(address)
        hdr = _recv_exact(sock, HEADER.size)
        if hdr is None:
            raise ConnectionError("server closed during handshake")
        magic, rate, hop, _slot = HEADER.unpack(hdr)
        if magic != MAGIC:
            raise ConnectionError("server full")
        wav, sr = read_audio(in_path)
        y = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
        if sr != rate:
            y = resample(torch.from_numpy(np.ascontiguousarray(y)), sr, rate).numpy()
        y = np.pad(y, (0, (-len(y)) % hop)).astype(np.float32)
        outs = []
        for k in range(len(y) // hop):
            sock.sendall(
                np.ascontiguousarray(y[k * hop : (k + 1) * hop], "<f4").tobytes()
            )
            raw = _recv_exact(sock, hop * 4)
            if raw is None:
                raise ConnectionError("server closed mid-stream")
            outs.append(np.frombuffer(raw, "<f4"))
        sock.shutdown(socket.SHUT_WR)
        raw = _recv_exact(sock, hop * 4)
        if raw is not None:
            outs.append(np.frombuffer(raw, "<f4"))
        audio = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    finally:
        sock.close()
    if out_path:
        write_wav(out_path, audio, rate)
    return audio


def parse_listen(listen: str) -> Address:
    """``--listen`` value -> server address: a path-looking value (leading
    ``/`` or ``./``, or no ``:``) is a unix socket, else ``HOST:PORT``."""
    if listen.startswith(("/", "./")) or ":" not in listen:
        return listen
    host, port = listen.rsplit(":", 1)
    return (host, int(port))


def load_decoder(conf: Config, lightning_ckpt: str = "") -> Decoder:
    """The decoder to serve: from a Lightning ``.ckpt`` when given, else
    from the newest ``step_*`` checkpoint under ``conf.checkpoint_dir``:
    the port trainer's (``state.pt``) or the JAX package trainer's (Orbax,
    read by ``models/orbax.py`` with numpy and the system's libzstd,
    ``models/convert.decoder_from_orbax``)."""
    from ddsp_tpu_torch.models.convert import load_lightning_decoder
    from ddsp_tpu_torch.training.trainer import latest_checkpoint, load_checkpoint_decoder

    if lightning_ckpt:
        return load_lightning_decoder(lightning_ckpt, conf)
    ckpt = latest_checkpoint(conf.checkpoint_dir)
    if ckpt is None:
        raise FileNotFoundError(
            f"no finalized checkpoint under {conf.checkpoint_dir!r} "
            "(pass --checkpoint_dir or --lightning_ckpt)"
        )
    return load_checkpoint_decoder(ckpt, conf)


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--help" in args or "-h" in args:
        print(
            "usage: python -m ddsp_tpu_torch.runtime.server "
            "[--checkpoint_dir=DIR | --lightning_ckpt=F.ckpt] "
            "[--crepe_checkpoint=F.pth]\n"
            "         [--listen=HOST:PORT|UNIX_PATH] [--n_streams=N] "
            "[--device=cuda|cpu] [--<config_field>=VALUE ...]\n\n"
            "Serve N concurrent real-time synth clients from one GPU over\n"
            "the multi-stream step.  Protocol: see the module docstring."
        )
        return
    listen = "127.0.0.1:9600"
    n_streams = 16
    device = "cuda"
    lightning_ckpt = crepe_checkpoint = ""
    rest = []
    for a in args:
        flag, sep, value = a.partition("=")
        if flag in ("--listen", "--n_streams", "--lightning_ckpt",
                    "--crepe_checkpoint", "--device"):
            if not sep:
                raise SystemExit(f"expected {flag}=value")
            if flag == "--listen":
                listen = value
            elif flag == "--n_streams":
                n_streams = int(value)
            elif flag == "--lightning_ckpt":
                lightning_ckpt = value
            elif flag == "--device":
                device = value
            else:
                crepe_checkpoint = value
        else:
            rest.append(a)
    conf = Config.from_flags(rest)
    resolve_device(device)  # fail before loading anything without a GPU

    from ddsp_tpu_torch.models.crepe import crepe_init, load_torch_checkpoint

    params = load_decoder(conf, lightning_ckpt)
    if crepe_checkpoint:
        crepe = load_torch_checkpoint(crepe_checkpoint, conf.crepe_capacity)
    else:
        print(
            "warning: no --crepe_checkpoint given; serving with randomly "
            "initialized CREPE weights (pitch tracking will be useless)",
            file=sys.stderr,
        )
        crepe = crepe_init(conf.crepe_capacity)

    server = StreamServer(
        params, crepe, conf, parse_listen(listen), n_streams=n_streams,
        device=device,
    ).start()
    print(
        f"serving {n_streams} stream slots on {listen} "
        f"(hop {conf.hop_length} @ {conf.sample_rate} Hz, {server.device})",
        flush=True,
    )
    try:
        while True:
            threading.Event().wait(3600)
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()
