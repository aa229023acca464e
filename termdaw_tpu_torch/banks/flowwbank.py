"""Carried over from termdaw_tpu/banks/flowwbank.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

FlowwBank: named note-event streams with block-cursor semantics.

A "floww" is an array of events, float32 rows (id, t_sec, note, vel) where
vel <= 0.001 means note-off (reference floww.rs:74, 114, 134). The bank keeps
the reference's time-cursor model exactly (floww.rs:70-141): a global `frame`,
per-floww `start_indices` advanced by `set_time` (full rescan) or
`set_time_to_next_block` (incremental skip), and per-block event iteration in
two flavors:

* drum mode (`get_block_drum`): at most one note-ON hit per frame, stale
  events skipped, note-offs ignored (floww.rs:99-121);
* simple mode (`get_block_simple`): all events at exactly the queried frame,
  in order; a stale event at the cursor blocks the rest of the block
  (floww.rs:124-141).

Instead of the reference's per-frame pull, this implementation exposes
**bake** methods that run the identical cursor semantics event-wise over a
range of blocks and return dense numpy event tables. The compiled XLA render
program consumes those tables; the per-frame Rust loops never existed here.

Event frames are computed as `int(float32(t) * float32(sr))` — float32
multiply then truncation — to match the reference's `(t * sr as f32) as
usize` (floww.rs:107).
"""

from __future__ import annotations

import itertools

from dataclasses import dataclass

import numpy as np

from ..fileio.midi import read_floww_from_midi, MidiError
from ..fileio.packets import FlowwPacket, KIND_EVENTS, KIND_TEXT


def event_frames(events: np.ndarray, sr: int) -> np.ndarray:
    """Map event times (seconds) to sample frames, f32-faithfully."""
    if events.shape[0] == 0:
        return np.zeros((0,), dtype=np.int64)
    t = events[:, 1].astype(np.float32)
    f = t * np.float32(sr)
    f = np.maximum(f, np.float32(0.0))  # Rust `as usize` clamps negatives to 0
    return f.astype(np.int64)


@dataclass
class DrumBake:
    """Baked drum-mode hits for a block range: absolute frames, notes, vels."""

    frames: np.ndarray  # int64 [H]
    notes: np.ndarray   # float32 [H]
    vels: np.ndarray    # float32 [H]

    @staticmethod
    def empty() -> "DrumBake":
        return DrumBake(
            np.zeros((0,), np.int64), np.zeros((0,), np.float32),
            np.zeros((0,), np.float32),
        )

    def filter_note(self, target: int | None) -> "DrumBake":
        """Apply the consumer-side note filter |note - n| < 0.01
        (reference extensions.rs:353-356)."""
        if target is None:
            return self
        keep = np.abs(self.notes - np.float32(target)) < 0.01
        return DrumBake(self.frames[keep], self.notes[keep], self.vels[keep])


@dataclass
class SimpleBake:
    """Baked simple-mode events: absolute frames, on flags, notes, vels."""

    frames: np.ndarray  # int64 [E]
    ons: np.ndarray     # bool  [E]
    notes: np.ndarray   # float32 [E]
    vels: np.ndarray    # float32 [E]

    @staticmethod
    def empty() -> "SimpleBake":
        z = np.zeros((0,), np.float32)
        return SimpleBake(np.zeros((0,), np.int64), np.zeros((0,), bool), z, z)


_FB_UIDS = itertools.count()


class FlowwBank:
    def __init__(self, sr: int, bl: int) -> None:
        self.sr = sr
        self.bl = bl
        self.frame = 0
        self.flowws: list[np.ndarray] = []
        self._si: list[int] = []
        # blocks advanced past but not yet reflected in _si (see
        # advance_blocks): `frame` is always current; index reconciliation
        # is deferred until something actually reads or mutates event
        # state. A fully chain-served render (graph/compile._prebake_take)
        # never bakes, so its per-window advances collapse into ONE
        # vectorized pass at the closing set_time.
        self._lag = 0
        self.names: dict[str, int] = {}
        self.stream_list: list[int] = []
        # per-floww (events_array_identity, frames, is_sorted) tuples; see
        # _event_frames
        self._frames_cache: list[tuple | None] = []
        # bumped whenever the event CONTENT may change (reset/declare/
        # append); CompiledGraph.seed_caps uses it to skip redundant
        # full-schedule prebakes
        self.version = 0
        # process-unique instance token: cache keys that outlive a bank
        # (seed memos, pooled-event caches) must not key on id(fb),
        # which the allocator can reuse after a bank is collected
        self.uid = next(_FB_UIDS)
        # pooled cursor index over the SORTED flowws (see _cursor_pool):
        # (version, flowws-identity snapshot, data)
        self._cursor_pool_cache: tuple | None = None
        # memoized set_time rescan results for the current content
        # generation: (version, flowws-identity snapshot, {t: indices}).
        # Only populated when EVERY floww has an event at/after t — then
        # the rescan overwrites every index with a value that depends
        # only on (events, t), never on the current indices (see
        # set_time). Repeat renders reset the cursor to the same start
        # frame every time; this turns that reset into a list copy.
        self._rescan_memo: tuple | None = None

    # pooled-cursor segment stride: one searchsorted over all sorted
    # flowws at once works by offsetting floww i's frames (and queries)
    # by i * STRIDE; any frame or query at/above it falls back to the
    # per-floww loop. 2^44 frames ~ 11.6 years at 48 kHz.
    _POOL_STRIDE = 1 << 44
    # below this many flowws the per-floww loop is already microseconds;
    # keep small projects on the simplest path
    _POOL_MIN_FLOWWS = 16

    def _cursor_pool(self):
        """Vectorized cursor index over every time-sorted floww: one
        np.searchsorted on a single concatenated key array answers
        "first event at/after t" for ALL of them at once. The per-floww
        Python loop in set_time/advance_blocks cost ~27 us per floww per
        call — at 256+ tracks that dominated render host time and at
        1024 streams it exceeded the 21.3 ms playback block budget by
        itself. Returns None (use the loop) for small banks or when any
        frame exceeds the segment stride; unsorted flowws are listed for
        the caller to handle with the existing per-floww code."""
        if len(self.flowws) < self._POOL_MIN_FLOWWS:
            return None
        c = self._cursor_pool_cache
        if c is not None and c[0] == self.version \
                and self._flowws_unchanged(c[1]):
            return c[2]
        sorted_idx: list[int] = []
        unsorted_idx: list[int] = []
        parts: list[np.ndarray] = []
        lens: list[int] = []
        lasts: list[int] = []
        for i in range(len(self.flowws)):
            f = self._event_frames(i)
            if self._frames_cache[i][2]:
                sorted_idx.append(i)
                parts.append(f)
                lens.append(len(f))
                lasts.append(int(f[-1]) if len(f) else -1)
            else:
                unsorted_idx.append(i)
        data = None
        if sorted_idx:
            nev = np.asarray(lens, np.int64)
            offsets = np.zeros(len(sorted_idx) + 1, np.int64)
            np.cumsum(nev, out=offsets[1:])
            pooled = (
                np.concatenate(parts).astype(np.int64, copy=False)
                if offsets[-1] else np.zeros(0, np.int64)
            )
            if len(pooled) and (
                int(pooled.max()) >= self._POOL_STRIDE
                or int(pooled.min()) < 0
            ):
                # out-of-range frames make the keyed concat non-monotonic
                # (a malformed NaN/inf event time maps to INT64_MIN via
                # event_frames' f32 cast — and sorts FIRST, so it also
                # passes the is-sorted check); binary search on that
                # would corrupt every pooled cursor. Loop path handles
                # such flowws benignly.
                data = None
            else:
                seg_base = (
                    np.arange(len(sorted_idx), dtype=np.int64)
                    * self._POOL_STRIDE
                )
                keyed = pooled + np.repeat(seg_base, nev)
                data = (
                    np.asarray(sorted_idx, np.int64),
                    unsorted_idx,
                    keyed,
                    offsets[:-1],
                    nev,
                    np.asarray(lasts, np.int64),
                    seg_base,
                )
        elif unsorted_idx:
            data = (
                np.zeros(0, np.int64), unsorted_idx, np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.int64),
            )
        self._cursor_pool_cache = (self.version, tuple(self.flowws), data)
        return data

    def _pool_starts(self, si: np.ndarray) -> np.ndarray:
        # np.array(list) + fancy-index is C-speed; a fromiter generator
        # over 1024 flowws cost ~1 ms per call and dominated the pooled
        # path
        return np.asarray(self._si, np.int64)[si]

    def _pool_writeback(self, si: np.ndarray, old: np.ndarray,
                        new: np.ndarray) -> None:
        if np.array_equal(new, old):
            return
        arr = np.asarray(self._si, np.int64)
        arr[si] = new
        self._si[:] = arr.tolist()

    def _event_frames(self, i: int) -> np.ndarray:
        """Cached event_frames per floww — the uncached version dominated
        multi-track render host time. The cache key is the identity of the
        events array itself, so a direct `fb.flowws[i] = new_events`
        replacement (tools and tests do this) can never serve stale
        frames; in-place writes into a live events array remain
        unsupported (nothing does that — all mutation paths replace the
        array)."""
        c = self._frames_cache[i]
        ev = self.flowws[i]
        if c is None or c[0] is not ev:
            f = event_frames(ev, self.sr)
            is_sorted = bool(np.all(f[1:] >= f[:-1])) if len(f) > 1 else True
            c = (ev, f, is_sorted)
            self._frames_cache[i] = c
        return c[1]

    def _frames_sorted(self, i: int) -> bool:
        self._event_frames(i)
        return self._frames_cache[i][2]

    # -- registration (reference floww.rs:23-64) ---------------------------
    def reset(self) -> None:
        self.frame = 0
        self._lag = 0
        self.flowws.clear()
        self._si.clear()
        self.names.clear()
        self.stream_list.clear()
        self._frames_cache.clear()
        self.version += 1

    def declare_floww(self, name: str, events: np.ndarray) -> int:
        # reconcile before the roster changes: deferred advances must be
        # resolved against the flowws that were live when they happened
        self._reconcile()
        events = np.asarray(events, dtype=np.float32).reshape(-1, 4)
        self.flowws.append(events)
        self._si.append(0)
        self._frames_cache.append(None)
        self.version += 1
        index = len(self.flowws) - 1
        self.names[name] = index
        return index

    def add_floww(self, name: str, path: str) -> None:
        """Load an SMF file. Raises (message formatted like the reference,
        floww.rs:45) on parse failure."""
        try:
            events = read_floww_from_midi(path)
        except (MidiError, OSError) as e:
            raise ValueError(
                f'Could not read midi file: "{path}". ({e})'
            ) from None
        self.declare_floww(name, events)

    def declare_stream(self, name: str) -> None:
        index = self.declare_floww(name, np.zeros((0, 4), np.float32))
        self.stream_list.append(index)

    def append_streams(self, packets: list[FlowwPacket]) -> list[str]:
        """Route EVENTS packets into named streams; return TEXT messages
        (reference floww.rs:55-57 `unpacket`)."""
        self._reconcile()  # indices must be current before events change
        msgs: list[str] = []
        grouped: dict[int, list[np.ndarray]] = {}
        for pkt in packets:
            if pkt.kind == KIND_TEXT:
                msgs.append(pkt.text)
            elif pkt.kind == KIND_EVENTS:
                idx = self.names.get(pkt.name)
                if idx is None:
                    msgs.append(f"unknown stream: {pkt.name}")
                    continue
                ev = pkt.events if pkt.events is not None \
                    else np.zeros((0, 4), np.float32)
                grouped.setdefault(idx, []).append(ev)
        # one concatenate + one version bump per call (a dense feed used
        # to pay an O(total) copy and a cache invalidation PER packet)
        for idx, evs in grouped.items():
            self.flowws[idx] = np.concatenate(
                [self.flowws[idx], *evs], axis=0
            )
            self._frames_cache[idx] = None
        if grouped:
            self.version += 1
        return msgs

    def trim_streams(self) -> None:
        """Drop consumed prefixes of stream flowws (reference floww.rs:59-64)."""
        self._reconcile()
        for index in self.stream_list:
            s = self._si[index]
            if s > 0:
                self.flowws[index] = self.flowws[index][s:]
                self._si[index] = 0
                self._frames_cache[index] = None
                self.version += 1

    def get_index(self, name: str) -> int | None:
        return self.names.get(name)

    # -- time cursor (reference floww.rs:70-96) ----------------------------
    def _set_start_indices_to_frame(self, t_frame: int, do_skip: bool) -> None:
        idxs = range(len(self.flowws))
        pool = (
            self._cursor_pool()
            if 0 <= t_frame < self._POOL_STRIDE else None
        )
        if pool is not None:
            si, unsorted_idx, keyed, offs, nev, _lasts, seg = pool
            if len(si):
                s0 = self._pool_starts(si)
                skip = s0 if do_skip else np.zeros(len(si), np.int64)
                k = np.searchsorted(keyed, seg + t_frame, "left") - offs
                new = np.where(
                    k < nev, np.where(k >= skip, k, skip), s0
                )
                self._pool_writeback(si, s0, new)
            idxs = unsorted_idx
        for i in idxs:
            skip = self._si[i] if do_skip else 0
            frames = self._event_frames(i)
            if self._frames_cache[i][2]:  # sorted: binary search
                k = int(frames.searchsorted(t_frame, "left"))
                if k < len(frames) and k >= skip:
                    self._si[i] = k
                elif k < len(frames):
                    self._si[i] = skip
                continue
            hit = np.nonzero(frames[skip:] >= t_frame)[0]
            if hit.size:
                self._si[i] = skip + int(hit[0])
            # quirk preserved: if no event is at/after t_frame the start
            # index is left unchanged (reference floww.rs:70-81)

    @property
    def start_indices(self) -> list[int]:
        """Per-floww cursor indices, reconciled with any deferred block
        advances before they are observed (the raw list lags `frame` by
        `_lag` blocks between reads — see advance_blocks)."""
        self._reconcile()
        return self._si

    def _flowws_unchanged(self, snapshot: tuple) -> bool:
        """Identity-level equality of the floww roster vs a snapshot —
        the same guard _cursor_pool uses against direct `fb.flowws[i] =
        new` replacement (the supported external mutation path, which
        does not bump version). Tuple == short-circuits on per-element
        identity; a replaced (non-identical) array falls through to
        ndarray.__eq__, whose truth value raises — proving the change."""
        try:
            return snapshot == tuple(self.flowws)
        except ValueError:
            return False

    def set_time(self, t: int) -> None:
        m = self._rescan_memo
        if m is not None and m[0] == self.version \
                and self._flowws_unchanged(m[1]):
            d = m[2]
            vals = d.get(t)
            if vals is not None:
                d[t] = d.pop(t)  # LRU: a hit keeps its entry evictable last
                # the memo exists only when every floww has an event
                # at/after t: the do_skip=False rescan then overwrites
                # EVERY index with a value independent of the current
                # ones (sorted: first event >= t; unsorted: first hit
                # from 0), so both the deferred-advance reconcile and
                # the "leave unchanged past the last event" quirk are
                # unobservable — skip the whole walk
                self._si[:] = vals
                self._lag = 0
                self.frame = t
                return
        # reconcile first: the rescan's "index unchanged when no event is
        # at/after t" quirk makes its result depend on the CURRENT indices
        self._reconcile()
        self._set_start_indices_to_frame(t, do_skip=False)
        self.frame = t
        self._memo_rescan(t)

    def _memo_rescan(self, t: int) -> None:
        """After a slow-path rescan to t, record the resulting indices
        when they are provably si-independent: every floww must have at
        least one event at/after t (the quirk never fires). A floww
        whose events all precede t (or an empty floww) disqualifies the
        whole bank for this t — fail closed, keep the slow path."""
        for i in range(len(self.flowws)):
            f = self._event_frames(i)
            if not len(f):
                return
            if self._frames_cache[i][2]:
                if int(f[-1]) < t:
                    return
            elif not bool((f >= t).any()):
                return
        m = self._rescan_memo
        if m is None or m[0] != self.version \
                or not self._flowws_unchanged(m[1]):
            m = (self.version, tuple(self.flowws), {})
            self._rescan_memo = m
        d = m[2]
        if len(d) >= 8 and t not in d:
            # bound the memo by evicting the LEAST-recently-hit entry
            # (dict order + move-to-end on hit) — wholesale clearing
            # dropped the hot render-reset t whenever a user scrubbed
            # through >8 distinct seek targets
            del d[next(iter(d))]
        d[t] = list(self._si)

    def set_time_to_next_block(self) -> None:
        self.advance_blocks(1)

    def advance_blocks(self, n: int) -> None:
        """Advance the cursor by n blocks — the exact composition of n
        `set_time_to_next_block` calls. The frame moves eagerly; the
        index update is DEFERRED until something reads or mutates event
        state (`_reconcile`), so advances over a span nobody inspects —
        every window of a chain-served render — cost one integer add,
        and consecutive spans fold into one vectorized pass."""
        if n <= 0:
            return
        self.frame += n * self.bl
        self._lag += n

    def _reconcile(self) -> None:
        lag = self._lag
        if lag:
            self._lag = 0
            self.frame -= lag * self.bl
            self._advance_now(lag)

    def _advance_now(self, n: int) -> None:
        """Move start indices across n blocks from the current frame,
        vectorized per floww (the stepped per-block version was
        O(blocks x flowws x events) and dominated multi-track render host
        time; equivalence with the stepped walk is property-tested).

        Composition of the reference's per-block skip (floww.rs:70-91):
        indices move monotonically to the first event at/after each block
        boundary, so the final index is the first event at/after the LAST
        boundary that still has one — boundaries beyond every event leave
        the index unchanged (quirk above).
        """
        t_final = self.frame + n * self.bl
        idxs = range(len(self.flowws))
        pool = (
            self._cursor_pool()
            if 0 <= self.frame and t_final < self._POOL_STRIDE else None
        )
        if pool is not None:
            si, unsorted_idx, keyed, offs, nev, lasts, seg = pool
            if len(si):
                s0 = self._pool_starts(si)
                new = s0.copy()
                active = s0 < nev
                k = np.searchsorted(keyed, seg + t_final, "left") - offs
                case_a = active & (k < nev)
                new[case_a] = np.maximum(s0[case_a], k[case_a])
                kb = (lasts - self.frame) // self.bl
                case_b = active & (k >= nev) & (kb >= 1)
                if case_b.any():
                    tk = self.frame + kb[case_b] * self.bl
                    k2 = (
                        np.searchsorted(keyed, seg[case_b] + tk, "left")
                        - offs[case_b]
                    )
                    new[case_b] = np.maximum(s0[case_b], k2)
                self._pool_writeback(si, s0, new)
            idxs = unsorted_idx
        for i in idxs:
            frames = self._event_frames(i)
            s0 = self._si[i]
            nev = len(frames)
            if s0 >= nev:
                continue
            if self._frames_cache[i][2]:  # sorted: binary search
                k = int(frames.searchsorted(t_final, "left"))
                if k < nev:
                    self._si[i] = max(s0, k)
                    continue
                kb = (int(frames[nev - 1]) - self.frame) // self.bl
                if kb >= 1:
                    tk = self.frame + kb * self.bl
                    k2 = int(frames.searchsorted(tk, "left"))
                    self._si[i] = max(s0, k2)
                continue
            tail = frames[s0:]
            hit = np.nonzero(tail >= t_final)[0]
            if hit.size:
                self._si[i] = s0 + int(hit[0])
                continue
            # no event reaches the final boundary: land on the largest
            # boundary some event does reach
            k = (int(tail.max()) - self.frame) // self.bl
            if k >= 1:
                tk = self.frame + k * self.bl
                hit2 = np.nonzero(tail >= tk)[0]
                if hit2.size:
                    self._si[i] = s0 + int(hit2[0])
        self.frame = t_final

    # -- baking (block-pull semantics, event-wise) -------------------------
    def bake_drum(self, index: int, n_blocks: int) -> DrumBake:
        """Replay `start_block` + per-frame `get_block_drum` over `n_blocks`
        blocks starting at the current cursor, without mutating state.

        Per block (reference floww.rs:93-121): the block pointer starts at
        the floww's start index; stale events (frame < query) are skipped;
        the first ON event at a queried frame is the hit (offs consumed and
        ignored); remaining same-frame events become stale. Start indices
        advance between blocks per floww.rs:88-91.
        """
        self._reconcile()
        if index >= len(self.flowws):
            return DrumBake.empty()
        events = self.flowws[index]
        frames = self._event_frames(index)
        if self._frames_sorted(index):
            # vectorized equivalent for time-sorted flowws (MIDI files and
            # streams are; the per-block Python replay below dominated
            # multi-track host time at 256 tracks x 375 blocks/window).
            # With sorted frames the per-block qmin walk reduces to: take
            # in-window events from the cursor on, keep ONs, and emit the
            # FIRST ON of each distinct frame (an ON sets qmin=f+1, making
            # later same-frame events stale; an OFF only advances qmin to
            # its own frame, so it never blocks a same-frame ON).
            s = self._si[index]
            t1 = self.frame + n_blocks * self.bl
            lo = max(s, int(np.searchsorted(frames, self.frame, "left")))
            hi = int(np.searchsorted(frames, t1, "left"))
            f = frames[lo:hi]
            v = events[lo:hi, 3]
            on = v > 0.001
            f = f[on]
            keep = np.ones(len(f), bool)
            if len(f) > 1:
                keep[1:] = f[1:] != f[:-1]
            return DrumBake(
                f[keep],
                events[lo:hi, 2][on][keep].astype(np.float32),
                v[on][keep].astype(np.float32),
            )
        vels = events[:, 3] if len(events) else np.zeros((0,), np.float32)
        notes = events[:, 2] if len(events) else np.zeros((0,), np.float32)
        n_ev = len(frames)
        s = self._si[index]
        out_f: list[int] = []
        out_n: list[float] = []
        out_v: list[float] = []
        blk_start = self.frame
        for _ in range(n_blocks):
            blk_end = blk_start + self.bl
            bi = s
            qmin = blk_start  # smallest frame not yet queried
            while bi < n_ev:
                f = frames[bi]
                if f < qmin:
                    bi += 1
                    continue
                if f >= blk_end:
                    break
                bi += 1
                if vels[bi - 1] > 0.001:
                    out_f.append(int(f))
                    out_n.append(float(notes[bi - 1]))
                    out_v.append(float(vels[bi - 1]))
                    qmin = int(f) + 1
                else:
                    # an off is consumed by the query at its own frame; the
                    # query frame has therefore advanced to f
                    qmin = int(f)
            # set_time_to_next_block for this floww (skip=True)
            j = s
            while j < n_ev:
                if frames[j] >= blk_end:
                    s = j
                    break
                j += 1
            blk_start = blk_end
        return DrumBake(
            np.asarray(out_f, dtype=np.int64),
            np.asarray(out_n, dtype=np.float32),
            np.asarray(out_v, dtype=np.float32),
        )

    def bake_simple(self, index: int, n_blocks: int) -> SimpleBake:
        """Replay `start_block` + per-frame `get_block_simple` over
        `n_blocks` blocks from the current cursor, without mutating state.

        Per query the reference returns the consecutive run of events whose
        frame equals the queried frame and stops at the first mismatch —
        including stale events, which therefore block the remainder of the
        block (reference floww.rs:124-141).
        """
        self._reconcile()
        if index >= len(self.flowws):
            return SimpleBake.empty()
        events = self.flowws[index]
        frames = self._event_frames(index)
        n_ev = len(frames)
        s = self._si[index]
        if self._frames_sorted(index) and not (s < n_ev and frames[s] < self.frame):
            # vectorized equivalent for time-sorted flowws with no stale
            # leftovers at the cursor (the common case; a stale event
            # blocks the rest of its block per floww.rs:124-141, which the
            # Python replay below handles). Sorted + fresh cursor means
            # every in-window event from the cursor on is emitted in order.
            t1 = self.frame + n_blocks * self.bl
            lo = s
            hi = int(np.searchsorted(frames, t1, "left"))
            v = events[lo:hi, 3].astype(np.float32)
            return SimpleBake(
                frames[lo:hi],
                v > 0.001,
                events[lo:hi, 2].astype(np.float32),
                v,
            )
        out_f: list[int] = []
        out_on: list[bool] = []
        out_n: list[float] = []
        out_v: list[float] = []
        blk_start = self.frame
        for _ in range(n_blocks):
            blk_end = blk_start + self.bl
            bi = s
            q = blk_start
            while bi < n_ev and q < blk_end:
                f = frames[bi]
                if f == q:
                    out_f.append(int(f))
                    out_on.append(bool(events[bi, 3] > 0.001))
                    out_n.append(float(events[bi, 2]))
                    out_v.append(float(events[bi, 3]))
                    bi += 1
                elif f > q:
                    if f >= blk_end:
                        break
                    q = int(f)
                else:
                    # stale event at the cursor: blocks the rest of the block
                    break
            j = s
            while j < n_ev:
                if frames[j] >= blk_end:
                    s = j
                    break
                j += 1
            blk_start = blk_end
        return SimpleBake(
            np.asarray(out_f, dtype=np.int64),
            np.asarray(out_on, dtype=bool),
            np.asarray(out_n, dtype=np.float32),
            np.asarray(out_v, dtype=np.float32),
        )
