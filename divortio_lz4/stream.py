"""Stateful streaming frame machines + stream wrappers.

Equivalents of the reference's L3/L4b layers:
- ``LZ4Encoder``  — rolling-window chunked frame encoder
  (src/shared/lz4Encode.js:96-339)
- ``LZ4Decoder``  — incremental frame-parsing FSM
  (src/shared/lz4Decode.js:48-271): byte-at-a-time feeding, dictID
  verification, concatenated frames
- ``CompressStream`` / ``DecompressStream`` — transform-stream style wrappers
  (src/stream/streamCompress.js:21-65, streamDecompress.js:23-58)

Design deltas vs the reference (deliberate):
- the hash table is re-warmed from the 64 KB window at each block flush with
  the one true hash, instead of shifting 16K entries by the consumed amount
  (lz4Encode.js:283-291) — same reachable matches, no stale-entry bugs;
- per-block staging uses the correct worst-case bound (block_bound), not the
  under-sized ``blockSize + 1024 + 4`` of lz4Encode.js:232;
- the encoder API is ``add``/``finish`` with a FrameConfig (the reference's
  tests and class drifted apart on names and argument order, SURVEY §2.9.3).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

import numpy as np

from .backends import get_backend
from .config import DEFAULT_CONFIG, FrameConfig
from .constants import (
    BLOCK_MAX_SIZES,
    BLOCK_SIZE_MASK,
    FLG_BLOCK_CHECKSUM,
    FLG_BLOCK_INDEPENDENCE,
    FLG_CONTENT_CHECKSUM,
    FLG_CONTENT_SIZE,
    FLG_DICT_ID,
    FLG_VERSION_MASK,
    LZ4_VERSION,
    MAGIC_NUMBER,
    UNCOMPRESSED_FLAG,
    WINDOW_SIZE,
    block_bound,
)
from .ops.block_ref import new_hash_table
from .utils import ensure_buffer, read_u32le, write_u32le
from .xxh import XXHash32, xxhash32


class LZ4Encoder:
    """Chunked LZ4 frame encoder with a rolling 64 KB linked-block window.

    ``add(chunk)`` returns a list of encoded byte chunks ready to emit;
    ``finish()`` flushes the remainder, EndMark, and optional content
    checksum. The carried streaming state is exactly the {window, hash
    warm-up source, hasher} tuple of SURVEY §5.4.
    """

    def __init__(self,
                 config: FrameConfig = DEFAULT_CONFIG,
                 dictionary=None,
                 backend: Optional[str] = None):
        # Streaming cannot know the total size up front; content_size is
        # forced off (the reference's streaming header never carries it).
        self.config = config.with_(content_size=False)
        # backend="device": bursts of >= _DEVICE_MIN_BLOCKS full
        # INDEPENDENT blocks in one add() batch through the device split
        # encoder (record walk + host serializer); remainders, linked
        # frames, and small feeds use the host backend. The reference's
        # analog is worker-stream offload (lz4.worker.js:36-68).
        self._device = backend == "device"
        self._be = get_backend(None if self._device else backend)
        self._block_size = self.config.resolved_block_size
        # Observability (VERDICT r3 #7): which backend actually served
        # each flushed block. Callers can assert/inspect offload behavior
        # instead of guessing from timings.
        self.stats = {"host_blocks": 0, "device_blocks": 0}
        self._pending = bytearray()
        self._header_sent = False
        self._finished = False
        self._hasher = XXHash32(0) if self.config.content_checksum else None
        self._dict_id = None
        self._history = b""
        if dictionary is not None:
            dict_buf = ensure_buffer(dictionary)
            if len(dict_buf) > 0:
                self._dict_id = xxhash32(dict_buf, 0)
                self._history = bytes(dict_buf[-WINDOW_SIZE:])

    # -- header -------------------------------------------------------------

    def _frame_header(self) -> bytes:
        cfg = self.config
        out = np.empty(19, dtype=np.uint8)
        out[0], out[1], out[2], out[3] = 0x04, 0x22, 0x4D, 0x18
        flg = LZ4_VERSION << 6
        if cfg.block_independence:
            flg |= FLG_BLOCK_INDEPENDENCE
        if cfg.content_checksum:
            flg |= FLG_CONTENT_CHECKSUM
        if cfg.block_checksums:
            flg |= FLG_BLOCK_CHECKSUM
        if self._dict_id is not None:
            flg |= FLG_DICT_ID
        out[4] = flg
        out[5] = (cfg.block_id & 0x07) << 4
        pos = 6
        if self._dict_id is not None:
            write_u32le(out, pos, self._dict_id)
            pos += 4
        out[pos] = (xxhash32(out[4:pos], 0) >> 8) & 0xFF
        pos += 1
        return bytes(out[:pos])

    # -- block flush --------------------------------------------------------

    def _flush_block(self, payload) -> bytes:
        """payload: np.uint8 array (zero-copy view from add) or bytes."""
        if isinstance(payload, (bytes, bytearray)):
            payload = np.frombuffer(bytes(payload), dtype=np.uint8)
        n = len(payload)
        hist = b"" if self.config.block_independence else self._history
        hist_len = len(hist)
        if hist_len > 0:
            working = np.empty(hist_len + n, dtype=np.uint8)
            working[:hist_len] = np.frombuffer(hist, dtype=np.uint8)
            working[hist_len:] = payload
        else:
            working = payload
        table = new_hash_table()
        if hist_len > 0:
            self._be.warm_table(table, working, hist_len)
        out = np.empty(4 + block_bound(n) + 4, dtype=np.uint8)
        comp = self._be.compress_block(working, out, hist_len, n, table, 4)
        if 0 < comp < n:
            write_u32le(out, 0, comp)
            end = 4 + comp
        else:
            write_u32le(out, 0, n | UNCOMPRESSED_FLAG)
            out[4: 4 + n] = payload
            end = 4 + n
        if self.config.block_checksums:
            write_u32le(out, end, xxhash32(out[4:end], 0))
            end += 4
        if not self.config.block_independence:
            # Keep only the last 64 KB: for payloads >= a window the whole
            # history is inside the payload (no need to materialize the
            # full hist+payload just to slice its tail).
            if n >= WINDOW_SIZE:
                self._history = payload[-WINDOW_SIZE:].tobytes()
            else:
                self._history = (hist + payload.tobytes())[-WINDOW_SIZE:]
        self.stats["host_blocks"] += 1
        return bytes(out[:end])

    # -- public API ---------------------------------------------------------

    def add(self, chunk) -> List[bytes]:
        """Feed a chunk; returns zero or more encoded output chunks."""
        if self._finished:
            raise RuntimeError("LZ4: Stream is closed")
        buf = ensure_buffer(chunk)
        outputs: List[bytes] = []
        if len(buf) == 0:
            return outputs
        if self._hasher is not None:
            self._hasher.update(buf)
        if not self._header_sent:
            self._header_sent = True
            outputs.append(self._frame_header())
        bs = self._block_size
        pos = 0
        if self._pending:
            # Top the carried remainder up to one block, then flush it.
            take = min(bs - len(self._pending), len(buf))
            self._pending += buf[:pos + take].tobytes()
            pos = take
            if len(self._pending) < bs:
                return outputs
            outputs.append(self._flush_block(bytes(self._pending)))
            self._pending.clear()
        # Whole blocks encode straight from the caller's buffer (zero-copy
        # views) — the accumulate-then-reslice copies measurably dominated
        # streaming encode of large feeds (profiled; the reference notes
        # the same compromise in lz4Encode.js:184-190 and keeps it).
        nfull = (len(buf) - pos) // bs
        if (self._device and nfull >= _DEVICE_MIN_BLOCKS
                and self._device_enc_ok()):
            if self.config.block_independence:
                outputs.extend(self._flush_blocks_device(
                    buf[pos: pos + nfull * bs], nfull))
                pos += nfull * bs
            else:
                outputs.extend(self._flush_blocks_device_linked(
                    buf[pos: pos + nfull * bs], nfull))
                pos += nfull * bs
        while len(buf) - pos >= bs:
            outputs.append(self._flush_block(buf[pos: pos + bs]))
            pos += bs
        if pos < len(buf):
            self._pending += buf[pos:].tobytes()
        return outputs

    def _device_enc_ok(self) -> bool:
        from .ops.hybrid_encode import hybrid_max_bs
        return (self._block_size <= hybrid_max_bs()
                and self._block_size % 1024 == 0 and self._dict_id is None)

    def _flush_blocks_device(self, payload: np.ndarray,
                             nfull: int) -> List[bytes]:
        """Batch nfull independent full blocks through the chain-direct
        encoder (one device dispatch for the candidate chains; host
        selection + serialization + framing)."""
        from .ops.split_encode import (chain_select_serialize,
                                       encode_blocks_chain)

        bs = self._block_size
        # Canonical 32-row dispatch shape: one compile serves any burst
        # size. Padding rows carry len 0 and are skipped.
        CH = 32
        nbp = -(-nfull // CH) * CH
        work = np.zeros((nbp, bs), np.int32)
        work[:nfull] = payload.astype(np.int32).reshape(nfull, bs)
        lens = np.zeros(nbp, np.int32)
        lens[:nfull] = bs
        chains = []
        for i in range(0, nbp, CH):
            chains.append(encode_blocks_chain(
                work[i: i + CH], lens[i: i + CH], bs, 0, 0))
        chains = np.concatenate([np.asarray(c) for c in chains])
        outputs: List[bytes] = []
        for i in range(nfull):
            row = payload[i * bs: (i + 1) * bs]
            wk = np.zeros(bs + 8, np.uint8)
            wk[:bs] = row
            comp = chain_select_serialize(wk, 0, bs, chains[i])
            outputs.append(self._frame_block_bytes(comp, row))
        self.stats["device_blocks"] += nfull
        return outputs

    def _flush_blocks_device_linked(self, payload: np.ndarray,
                                    nfull: int) -> List[bytes]:
        """Batch nfull LINKED full blocks through the chain-direct encoder.

        The linked chain's serialism is an encoder-side illusion: block
        i's 64 KB window is known plaintext (the carried history + the
        burst's own earlier blocks), so every block gets a [history |
        payload] row and ONE device dispatch builds all candidate chains
        (same trick as parallel/device._compress_linked_split). Host
        select/serialize runs per block; the carried window advances past
        the whole burst. VERDICT r3 #7."""
        from .ops.split_encode import (chain_select_serialize,
                                       encode_blocks_chain)

        bs = self._block_size
        W = WINDOW_SIZE
        pre = np.frombuffer(self._history, np.uint8)
        full = np.concatenate([pre, payload])
        hist = np.zeros((nfull, W), np.uint8)
        hist_start = np.empty(nfull, np.int32)
        for i in range(nfull):
            start = len(pre) + i * bs
            avail = min(start, W)
            if avail:
                hist[i, W - avail:] = full[start - avail: start]
            hist_start[i] = W - avail
        work = np.zeros((nfull, W + bs), np.int32)
        work[:, :W] = hist
        work[:, W:] = payload.reshape(nfull, bs)
        lens = np.full(nfull, bs, np.int32)

        CH = 32
        nbp = -(-nfull // CH) * CH
        if nbp > nfull:
            work = np.concatenate(
                [work, np.zeros((nbp - nfull, W + bs), np.int32)])
            lens = np.concatenate([lens, np.zeros(nbp - nfull, np.int32)])
            hist_start = np.concatenate(
                [hist_start, np.full(nbp - nfull, W, np.int32)])
        chains = []
        import jax.numpy as jnp
        for i in range(0, nbp, CH):
            chains.append(encode_blocks_chain(
                work[i: i + CH], lens[i: i + CH], bs, W,
                jnp.asarray(hist_start[i: i + CH])))
        chains = np.concatenate([np.asarray(c) for c in chains])
        outputs: List[bytes] = []
        for i in range(nfull):
            row = payload[i * bs: (i + 1) * bs]
            wk = np.zeros(W + bs + 8, np.uint8)
            wk[:W] = hist[i]
            wk[W: W + bs] = row
            comp = chain_select_serialize(wk, W, bs, chains[i])
            outputs.append(self._frame_block_bytes(comp, row))
        self._history = full[-W:].tobytes() if len(full) >= W \
            else full.tobytes()
        self.stats["device_blocks"] += nfull
        return outputs

    def _frame_block_bytes(self, comp: np.ndarray,
                           payload: np.ndarray) -> bytes:
        """Wire framing for one already-compressed block: size word,
        stored fallback, optional block checksum (the same tail
        _flush_block composes in place around its compress destination)."""
        n = len(payload)
        clen = len(comp)
        out = np.empty(4 + max(clen, n) + 4, np.uint8)
        if 0 < clen < n:
            write_u32le(out, 0, clen)
            out[4: 4 + clen] = comp
            end = 4 + clen
        else:
            write_u32le(out, 0, n | UNCOMPRESSED_FLAG)
            out[4: 4 + n] = payload
            end = 4 + n
        if self.config.block_checksums:
            write_u32le(out, end, xxhash32(out[4:end], 0))
            end += 4
        return bytes(out[:end])

    # Alias for drop-in familiarity with the reference's test-suite name.
    update = add

    # -- checkpoint/resume ---------------------------------------------------
    # The carried streaming state is exactly {pending input, 64KB window,
    # hasher, framing flags} (SURVEY §5.4); snapshots are plain dicts safe
    # to pickle/JSON-encode (bytes fields) for session migration.

    def state_dict(self) -> dict:
        return {
            "config": self.config.__dict__.copy(),
            "pending": bytes(self._pending),
            "header_sent": self._header_sent,
            "finished": self._finished,
            "dict_id": self._dict_id,
            "history": self._history,
            "hasher": self._hasher.state_dict() if self._hasher else None,
        }

    @classmethod
    def from_state(cls, state: dict, backend: Optional[str] = None
                   ) -> "LZ4Encoder":
        cfg = FrameConfig(**state["config"])
        enc = cls(cfg, None, backend)
        enc._pending = bytearray(state["pending"])
        enc._header_sent = state["header_sent"]
        enc._finished = state["finished"]
        enc._dict_id = state["dict_id"]
        enc._history = state["history"]
        if state["hasher"] is not None:
            enc._hasher = XXHash32.from_state(state["hasher"])
        return enc

    def finish(self) -> List[bytes]:
        """Flush remaining data, EndMark, and optional content checksum."""
        if self._finished:
            raise RuntimeError("LZ4: Stream is closed")
        self._finished = True
        outputs: List[bytes] = []
        if not self._header_sent:
            self._header_sent = True
            outputs.append(self._frame_header())
        while self._pending:
            payload = bytes(self._pending[: self._block_size])
            del self._pending[: self._block_size]
            outputs.append(self._flush_block(payload))
        tail = np.empty(8, dtype=np.uint8)
        write_u32le(tail, 0, 0)
        end = 4
        if self._hasher is not None:
            write_u32le(tail, 4, self._hasher.digest())
            end = 8
        outputs.append(bytes(tail[:end]))
        return outputs


# FSM states (lz4Decode.js:27-31, plus SKIP for skippable frames).
# Minimum buffered full blocks before the device engines batch a dispatch
# (below it, per-dispatch latency loses to the host tier).
_DEVICE_MIN_BLOCKS = 4

_S_MAGIC = 0
_S_HEADER = 1
_S_BLOCK_SIZE = 2
_S_BLOCK_BODY = 3
_S_CHECKSUM = 4
_S_SKIP = 5


class LZ4Decoder:
    """Incremental LZ4 frame decoder FSM.

    Feed arbitrary fragments (even single bytes) via ``update``; decoded
    chunks are returned as they complete. After a frame's checksum the state
    returns to MAGIC so concatenated frames decode seamlessly
    (lz4Decode.js:262-267).
    """

    def __init__(self, dictionary=None, verify_checksum: bool = True,
                 backend: Optional[str] = None):
        # backend="device": when >= _DEVICE_MIN_BLOCKS complete INDEPENDENT
        # blocks sit buffered, they decode as ONE batched dispatch of the
        # region kernel (ops/gpu_decode.decode_blocks); fragments, linked
        # frames, and dictionaries use the host backend.
        self._device = backend == "device"
        self._be = get_backend(None if self._device else backend)
        # Observability (VERDICT r3 #7): blocks served per backend.
        self.stats = {"host_blocks": 0, "device_blocks": 0}
        self.verify_checksum = verify_checksum
        self._dict = ensure_buffer(dictionary) if dictionary is not None else None
        self._buf = bytearray()
        self._state = _S_MAGIC
        self._hasher = XXHash32(0)
        # Per-frame output bound (refined from the header's BD byte).
        self._block_max = BLOCK_MAX_SIZES[7]
        self._reset_frame_state()

    def _reset_frame_state(self):
        self._skip_remaining = 0
        self._flg = 0
        self._has_block_checksum = False
        self._has_content_size = False
        self._has_content_checksum = False
        self._has_dict_id = False
        self._block_word = 0
        self._window = np.zeros(WINDOW_SIZE, dtype=np.uint8)
        self._window_pos = 0
        if self._dict is not None:
            d = len(self._dict)
            take = min(d, WINDOW_SIZE)
            self._window[:take] = self._dict[d - take:]
            self._window_pos = take
        self._hasher.reset()

    def update(self, chunk) -> List[np.ndarray]:
        """Feed bytes; returns decoded chunks (possibly empty)."""
        buf = ensure_buffer(chunk)
        self._buf += buf.tobytes()
        outputs: List[np.ndarray] = []

        while True:
            if self._state == _S_MAGIC:
                if len(self._buf) < 4:
                    break
                word = read_u32le(self._buf, 0)
                from .constants import (SKIPPABLE_MAGIC_MAX,
                                        SKIPPABLE_MAGIC_MIN)
                if SKIPPABLE_MAGIC_MIN <= word <= SKIPPABLE_MAGIC_MAX:
                    if len(self._buf) < 8:
                        break
                    self._skip_remaining = read_u32le(self._buf, 4)
                    del self._buf[:8]
                    self._state = _S_SKIP
                    continue
                if word != MAGIC_NUMBER:
                    raise ValueError("LZ4: Invalid Magic Number")
                del self._buf[:4]
                self._state = _S_HEADER

            elif self._state == _S_SKIP:
                take_n = min(self._skip_remaining, len(self._buf))
                del self._buf[:take_n]
                self._skip_remaining -= take_n
                if self._skip_remaining > 0:
                    break
                self._state = _S_MAGIC

            elif self._state == _S_HEADER:
                if len(self._buf) < 2:
                    break
                flg = self._buf[0]
                version = (flg & FLG_VERSION_MASK) >> 6
                if version != LZ4_VERSION:
                    raise ValueError(f"LZ4: Unsupported Version {version}")
                hdr_len = 2 + 1  # FLG + BD + header checksum
                if flg & FLG_CONTENT_SIZE:
                    hdr_len += 8
                if flg & FLG_DICT_ID:
                    hdr_len += 4
                if len(self._buf) < hdr_len:
                    break
                self._flg = flg
                self._block_max = BLOCK_MAX_SIZES.get(
                    (self._buf[1] >> 4) & 0x07, BLOCK_MAX_SIZES[7])
                self._has_block_checksum = bool(flg & FLG_BLOCK_CHECKSUM)
                self._has_content_size = bool(flg & FLG_CONTENT_SIZE)
                self._has_content_checksum = bool(flg & FLG_CONTENT_CHECKSUM)
                self._has_dict_id = bool(flg & FLG_DICT_ID)
                pos = 2
                if self._has_content_size:
                    pos += 8  # streaming decode never pre-allocates from it
                if self._has_dict_id:
                    frame_dict_id = read_u32le(self._buf, pos)
                    pos += 4
                    # dictID verification (lz4Decode.js:165-179).
                    if self._dict is None:
                        raise ValueError("LZ4: Frame requires a Dictionary")
                    if xxhash32(self._dict, 0) != frame_dict_id:
                        raise ValueError("LZ4: Dictionary ID Mismatch")
                # Header-checksum byte (skipped by the reference; verified
                # here so a corrupted descriptor raises instead of
                # misparsing the frame).
                if self.verify_checksum:
                    desc = np.frombuffer(
                        bytes(self._buf[: hdr_len - 1]), np.uint8)
                    if ((xxhash32(desc, 0) >> 8) & 0xFF) \
                            != self._buf[hdr_len - 1]:
                        raise ValueError("LZ4: Header Checksum Error")
                del self._buf[:hdr_len]
                self._state = _S_BLOCK_SIZE

            elif self._state == _S_BLOCK_SIZE:
                if len(self._buf) < 4:
                    break
                if self._device and (self._flg & FLG_BLOCK_INDEPENDENCE) \
                        and self._dict is None:
                    from .parallel.device import REGION_KERNEL_MAX_BLOCK
                    if self._block_max <= REGION_KERNEL_MAX_BLOCK \
                            and self._try_batch_decode(outputs):
                        continue
                word = read_u32le(self._buf, 0)
                del self._buf[:4]
                if word == 0:
                    # EndMark.
                    if self._has_content_checksum:
                        self._state = _S_CHECKSUM
                    else:
                        self._state = _S_MAGIC
                        self._reset_frame_state()
                else:
                    self._block_word = word
                    self._state = _S_BLOCK_BODY

            elif self._state == _S_BLOCK_BODY:
                bsize = self._block_word & BLOCK_SIZE_MASK
                need = bsize + (4 if self._has_block_checksum else 0)
                if len(self._buf) < need:
                    break
                # Zero-copy view of the wire bytes; released before the
                # buffer mutates (a bytearray cannot shrink with exported
                # views). Stored blocks copy out, compressed blocks only
                # ever read through it.
                mv = memoryview(self._buf)[:bsize]
                data = np.frombuffer(mv, dtype=np.uint8)
                if self._has_block_checksum:
                    stored_bc = read_u32le(self._buf, bsize)
                    if self.verify_checksum and \
                            stored_bc != xxhash32(data, 0):
                        raise ValueError("LZ4: Block Checksum Error")
                if self._block_word & UNCOMPRESSED_FLAG:
                    chunk_out = np.array(data)
                else:
                    if self._flg & FLG_BLOCK_INDEPENDENCE:
                        # Spec semantics: an independent block's window
                        # resets — history is the dictionary only.
                        hist = self._dict
                    else:
                        hist = (self._window[: self._window_pos]
                                if self._window_pos > 0 else None)
                    # Fresh per-block buffer: the returned chunk is a
                    # VIEW (no copy-out), safe because nothing reuses it.
                    dst = np.empty(self._block_max, dtype=np.uint8)
                    n = self._be.decompress_block(
                        data, 0, bsize, dst, 0, hist)
                    chunk_out = dst[:n]
                data = None
                mv.release()
                del self._buf[:need]
                if self._has_content_checksum:
                    self._hasher.update(chunk_out)
                self._update_window(chunk_out)
                outputs.append(chunk_out)
                self.stats["host_blocks"] += 1
                self._state = _S_BLOCK_SIZE

            elif self._state == _S_CHECKSUM:
                if len(self._buf) < 4:
                    break
                stored = read_u32le(self._buf, 0)
                del self._buf[:4]
                if self.verify_checksum and stored != self._hasher.digest():
                    raise ValueError("LZ4: Content Checksum Error")
                self._state = _S_MAGIC
                self._reset_frame_state()

        return outputs

    def _try_batch_decode(self, outputs: List[np.ndarray]) -> bool:
        """Scan buffered complete independent blocks; batch-decode them in
        one device dispatch when >= _DEVICE_MIN_BLOCKS are available.
        Returns True when it consumed input (state stays _S_BLOCK_SIZE)."""
        spans = []  # (data_off, bsize, stored, ck_off)
        p = 0
        n = len(self._buf)
        ck = 4 if self._has_block_checksum else 0
        while p + 4 <= n:
            word = read_u32le(self._buf, p)
            if word == 0:
                break
            bsize = word & BLOCK_SIZE_MASK
            if bsize > self._block_max or p + 4 + bsize + ck > n:
                break
            spans.append((p + 4, bsize, bool(word & UNCOMPRESSED_FLAG),
                          p + 4 + bsize))
            p += 4 + bsize + ck
        if len(spans) < _DEVICE_MIN_BLOCKS:
            return False
        # Batch a pow2 bucket of blocks (shape-canonical dispatches — see
        # the encoder note); the remainder stays buffered for the next
        # update()/FSM pass.
        b = _DEVICE_MIN_BLOCKS
        while b * 2 <= min(len(spans), 64):
            b *= 2
        spans = spans[:b]
        p = spans[-1][3] + (4 if self._has_block_checksum else 0)
        from .ops.gpu_decode import decode_blocks
        buf_np = np.frombuffer(bytes(self._buf[:p]), np.uint8)
        if self._has_block_checksum and self.verify_checksum:
            for off, bsize, _, cko in spans:
                if read_u32le(self._buf, cko) \
                        != xxhash32(buf_np[off: off + bsize], 0):
                    raise ValueError("LZ4: Block Checksum Error")
        comp_idx = [i for i, s in enumerate(spans) if not s[2]]
        decoded = decode_blocks(
            [buf_np[spans[i][0]: spans[i][0] + spans[i][1]]
             for i in comp_idx], self._block_max)
        dec_map = dict(zip(comp_idx, decoded))
        for i, (off, bsize, stored, _) in enumerate(spans):
            chunk = (np.array(buf_np[off: off + bsize]) if stored
                     else dec_map[i])
            if self._has_content_checksum:
                self._hasher.update(chunk)
            self._update_window(chunk)
            outputs.append(chunk)
        del self._buf[:p]
        self.stats["device_blocks"] += len(spans)
        return True

    def _update_window(self, chunk: np.ndarray) -> None:
        """Three-case rolling window update (lz4Decode.js:279-306)."""
        cl = len(chunk)
        if cl >= WINDOW_SIZE:
            self._window[:] = chunk[cl - WINDOW_SIZE:]
            self._window_pos = WINDOW_SIZE
        elif self._window_pos + cl <= WINDOW_SIZE:
            self._window[self._window_pos: self._window_pos + cl] = chunk
            self._window_pos += cl
        else:
            keep = WINDOW_SIZE - cl
            self._window[:keep] = self._window[self._window_pos - keep:
                                               self._window_pos]
            self._window[keep:] = chunk
            self._window_pos = WINDOW_SIZE

    @property
    def finished_frame(self) -> bool:
        """True when positioned at a frame boundary (safe resume point)."""
        return self._state == _S_MAGIC and not self._buf

    # -- checkpoint/resume ---------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "verify": self.verify_checksum,
            "dict": None if self._dict is None else bytes(self._dict),
            "buf": bytes(self._buf),
            "state": self._state,
            "flags": (self._flg, self._has_block_checksum,
                      self._has_content_size, self._has_content_checksum,
                      self._has_dict_id),
            "block_word": self._block_word,
            "window": bytes(self._window[: self._window_pos]),
            "hasher": self._hasher.state_dict(),
        }

    @classmethod
    def from_state(cls, state: dict, backend: Optional[str] = None
                   ) -> "LZ4Decoder":
        dec = cls(state["dict"], state["verify"], backend)
        dec._buf = bytearray(state["buf"])
        dec._state = state["state"]
        (dec._flg, dec._has_block_checksum, dec._has_content_size,
         dec._has_content_checksum, dec._has_dict_id) = state["flags"]
        dec._block_word = state["block_word"]
        w = np.frombuffer(state["window"], np.uint8)
        dec._window[: len(w)] = w
        dec._window_pos = len(w)
        dec._hasher = XXHash32.from_state(state["hasher"])
        return dec


class CompressStream:
    """Transform-stream style wrapper around LZ4Encoder.

    ``write`` returns encoded bytes; ``flush`` terminates the frame. Also
    usable as a pipe over any byte-chunk iterable.
    """

    def __init__(self, config: FrameConfig = DEFAULT_CONFIG, dictionary=None,
                 backend: Optional[str] = None):
        self._enc = LZ4Encoder(config, dictionary, backend)

    def write(self, chunk) -> bytes:
        return b"".join(self._enc.add(chunk))

    def flush(self) -> bytes:
        return b"".join(self._enc.finish())

    def pipe(self, chunks: Iterable) -> Iterator[bytes]:
        for c in chunks:
            out = self.write(c)
            if out:
                yield out
        tail = self.flush()
        if tail:
            yield tail


class DecompressStream:
    """Transform-stream style wrapper around LZ4Decoder."""

    def __init__(self, dictionary=None, verify_checksum: bool = True,
                 backend: Optional[str] = None):
        self._dec = LZ4Decoder(dictionary, verify_checksum, backend)

    def write(self, chunk) -> bytes:
        return b"".join(bytes(c) for c in self._dec.update(chunk))

    def flush(self) -> bytes:
        # Frames self-terminate; flush is a no-op (streamDecompress.js:55-57).
        return b""

    def pipe(self, chunks: Iterable) -> Iterator[bytes]:
        for c in chunks:
            out = self.write(c)
            if out:
                yield out


def create_compress_stream(config: FrameConfig = DEFAULT_CONFIG,
                           dictionary=None,
                           backend: Optional[str] = None) -> CompressStream:
    return CompressStream(config, dictionary, backend)


def create_decompress_stream(dictionary=None, verify_checksum: bool = True,
                             backend: Optional[str] = None) -> DecompressStream:
    return DecompressStream(dictionary, verify_checksum, backend)


def compress_file(src_path: str, dst_path: str,
                  config: FrameConfig = DEFAULT_CONFIG,
                  dictionary=None, chunk_size: int = 1 << 22,
                  backend: Optional[str] = None) -> int:
    """Stream-compress a file; returns compressed byte count."""
    total = 0
    stream = CompressStream(config, dictionary, backend)
    with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
        while True:
            chunk = fin.read(chunk_size)
            if not chunk:
                break
            out = stream.write(chunk)
            total += len(out)
            fout.write(out)
        tail = stream.flush()
        total += len(tail)
        fout.write(tail)
    return total


def decompress_file(src_path: str, dst_path: str, dictionary=None,
                    verify_checksum: bool = True, chunk_size: int = 1 << 22,
                    backend: Optional[str] = None) -> int:
    """Stream-decompress a file; returns plaintext byte count."""
    total = 0
    stream = DecompressStream(dictionary, verify_checksum, backend)
    with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
        while True:
            chunk = fin.read(chunk_size)
            if not chunk:
                break
            out = stream.write(chunk)
            total += len(out)
            fout.write(out)
    return total
