"""Mesh-sharded search: the haystack split data-parallel over torch devices.

The PyTorch port of the JAX package's ``parallel/shard.py``. The
reference is single-threaded; its stream decomposition (roll buffer
carrying max_pattern_len bytes of overlap, util/buffer.rs:107-123) proves
search state is carried across chunk boundaries. This module scales that
decomposition across a mesh of devices:

  - the haystack is sharded data-parallel with a ``halo`` byte overlap
    (the suffix property makes per-position states exact once the walk has
    consumed >= max_pattern_len bytes, see ops/block_scan.py),
  - pattern tables are replicated to every device (each engine's tables
    are cached per device),
  - per-shard match counts are reduced to one scalar,
  - per-shard match positions are gathered in shard order for triples.

The JAX module runs one program over a ``jax.sharding.Mesh``
(``shard_map``); its halos are built on the host, and its only
collectives are a ``psum``, a ``pmax`` and the gather of per-shard
results. So here a mesh is a list of torch devices driven from one
process: each shard's rows are uploaded to its device and the port's
kernel wrappers launch there; the ``psum`` is a sum of the per-shard
device scalars on the mesh's first device read with one ``.item()``, the
``pmax`` a max of the shards' host counts, the gather a concatenation in
shard order. A list may repeat a device (``Mesh(["cpu"] * 8)``, four
entries of ``cuda:0``): each entry is one shard.

Each shard's row starts at its first haystack byte: shard i owns
``[i * shard, (i + 1) * shard)`` and its row holds the bytes from
``max(0, i * shard - halo)``, so the first shard has no halo and no fill
byte precedes the haystack. (The JAX module zero-fills the first shard's
halo, which makes a pattern holding NUL bytes match across the
haystack's start: ROADMAP R8.) Matches are owned by the shard in which
they end (for the cascade, in which their coarse prefix ends): the
kernels' count window, or a filter of the candidate positions, keeps the
others out.

Shard sizes are the JAX module's: rounded to 4 bytes in the kernel
functions and to 128 for the device walk.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ahocorasick import _resolve_device
from ..ops import bitap as _bitap
from ..ops import bitap_kernels as _bk
from ..ops import fingerprint_kernels as _fk
from ..ops import staged as _staged
from ..ops import staged_kernels as _sk
from ..ops.bitap import LANES, _pow2, _to_stream_major, decode_match_words
from ..ops import walk_kernels as _wk
from ..ops.block_scan import DeviceWalkEngine, _round_up, choose_block_len
from ..ops.compaction import select_matches, select_nonzero_words


class Mesh:
    """The devices of a sharded search, one shard per entry (an entry may
    repeat a device)."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [_resolve_device(d)
                                            for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` devices: ``cuda:0 .. cuda:k-1`` (every card
    by default; raises without one), or ``n_devices`` entries of the CPU
    (one by default)."""
    dev = _resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (1 if n_devices is None else n_devices))
    have = torch.cuda.device_count()
    k = have if n_devices is None else n_devices
    if not 1 <= k <= have:
        raise ValueError(f"{k} devices asked for, {have} present")
    return Mesh([torch.device("cuda", i) for i in range(k)])


class _Rows:
    """Host rows of a sharded haystack: ``rows [ndev, row_bytes]`` uint8
    filled with ``pad``; row i holds the bytes ``[origin[i], origin[i] +
    nv[i])`` (its halo of at most ``halo`` bytes, its own shard, and up to
    ``fwd`` bytes of its right neighbour's), and owns the row positions
    ``[n0[i], n1[i])``."""

    def __init__(self, haystack: bytes, ndev: int, shard: int, halo: int,
                 row_bytes: int, pad: int = 0, fwd: int = 0):
        n = len(haystack)
        buf = np.frombuffer(haystack, dtype=np.uint8)
        self.rows = np.full((ndev, row_bytes), pad, dtype=np.uint8)
        self.origin, self.n0, self.n1, self.nv = [], [], [], []
        for i in range(ndev):
            g0 = i * shard
            lo = min(max(0, g0 - halo), n)
            seg = buf[lo:min(g0 + shard + fwd, n)]
            if len(seg) > row_bytes:
                raise ValueError("shard row too short for its bytes")
            self.rows[i, :len(seg)] = seg
            self.origin.append(lo)
            self.n0.append(min(g0, n) - lo)
            self.n1.append(min(g0, n) - lo + max(0, min(n - g0, shard)))
            self.nv.append(len(seg))

    def upload(self, i: int, device: torch.device) -> torch.Tensor:
        """Row i as int32 words on ``device``."""
        return torch.from_numpy(self.rows[i].view(np.int32)).to(device)


def _psum(values: Sequence[torch.Tensor], mesh: Mesh) -> int:
    """The sum of per-shard device scalars, reduced on the mesh's first
    device; one value returns to the host."""
    d0 = mesh.devices[0]
    return int(torch.stack([v.to(d0).to(torch.int64).reshape(())
                            for v in values]).sum().item())


def _walk_tables(dev: DeviceWalkEngine, device: torch.device):
    return (dev.trans_flat.to(device), dev.classes.to(device),
            dev.match_count.to(device))


def sharded_count_matches(
    dev: DeviceWalkEngine,
    haystack: bytes,
    mesh: Optional[Mesh] = None,
) -> int:
    """Total overlapping-match count, sharded across the mesh: the blocked
    device DFA walk's count (W2, the port of ``count_kernel``) over each
    shard's row, its window the positions the shard owns, no state array;
    the partial counts are summed on the mesh's first device."""
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size
    halo = max(dev.halo, 0)
    extra = 0
    # Start-state matches at position 0 (empty pattern).
    if 2 <= dev.start_id <= dev.max_match_id:
        extra = int(
            dev.dfa.match_starts[dev.start_id + 1]
            - dev.dfa.match_starts[dev.start_id]
        )
    if len(haystack) == 0:
        return extra
    shard = _round_up(-(-len(haystack) // ndev), 128)
    block_len = choose_block_len(shard, halo)
    row_bytes = _round_up(halo + shard, block_len)
    lay = _Rows(haystack, ndev, shard, halo, row_bytes)
    tables = {d: _walk_tables(dev, d) for d in set(mesh.devices)}
    counts = []
    for i, d in enumerate(mesh.devices):
        trans_flat, classes, match_count = tables[d]
        row = torch.from_numpy(lay.rows[i]).to(d)
        counts.append(_wk.walk_count(trans_flat, classes, row,
                                     dev.alphabet_len, dev.start_id,
                                     block_len, halo, match_count,
                                     lay.n0[i], lay.n1[i]))
    return _psum(counts, mesh) + extra


def _bitap_shard(eng, lay: _Rows, i: int, d: torch.device, L: int,
                 tiles: int, extract: bool):
    """G1 over shard i's row on ``d``, its window the owned positions."""
    x32 = lay.upload(i, d)
    halo_a, body = _to_stream_major(x32, L, tiles, eng.halo)
    lo, hi, sm, em = eng.tables.device_tensors(d)
    return _bk.bitap_scan_generic(lo, hi, sm, em, halo_a, body, lay.n0[i],
                                  lay.n1[i], extract)


def sharded_bitap_count(
    eng,  # ops.bitap.BitapEngine
    haystack: bytes,
    mesh: Optional[Mesh] = None,
) -> int:
    """Mesh-parallel overlapping-match count on the bit-parallel engine.

    Data-parallel over the haystack: every device gets a contiguous shard
    prefixed by a ``halo`` of its left neighbor's tail (state warmup —
    the reference's roll-buffer carry, util/buffer.rs:107-123, across
    devices instead of across read() calls). Each device runs the
    table-generic shift-AND kernel (G1) on its shard with the count
    window set to the positions it owns; the partial counts are summed on
    the mesh's first device and one scalar returns.
    """
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size
    n = len(haystack)
    if n == 0:
        return 0
    shard = _round_up(-(-n // ndev), 4)
    L, tiles = eng._layout(eng.halo + shard)
    lay = _Rows(haystack, ndev, shard, eng.halo, tiles * LANES * L)
    totals = [_bitap_shard(eng, lay, i, d, L, tiles, False)[0].sum()
              for i, d in enumerate(mesh.devices)]
    return _psum(totals, mesh)


def sharded_staged_count(
    eng,  # ops.staged.StagedEngine
    haystack: bytes,
    mesh: Optional[Mesh] = None,
) -> int:
    """Mesh-parallel two-stage count: per shard, the prefix-chain flags
    (G3) over the shard's rows, the flagged streams' ids
    (``select_nonzero_words``) and the exact rescan of their rows (G4)
    over the owned window; partial counts summed on the first device.

    This keeps the sharded large-count path on the SAME engine the
    single-device facade prefers for large counts. The rescan cap is
    shared by the shards and grown from their largest candidate count,
    like the single-device adaptive loop; it is clamped to the number of
    streams ``ns``, where every shard fits (the JAX function lets it pass
    a non-power-of-two ``ns`` and returns None: ROADMAP R2), so the
    count always stays on the staged path. The flags
    are computed once; a larger cap only selects again."""
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size
    n = len(haystack)
    if n == 0:
        return 0
    halo = eng.halo
    pad = eng.full.pad_byte
    if pad is None:
        raise ValueError("the staged engine needs a pad byte")
    shard = _round_up(-(-n // ndev), 4)
    L, _, tiles = eng._layout(halo + shard)
    ns = tiles * LANES
    lay = _Rows(haystack, ndev, shard, halo, ns * L, pad=pad)
    shards = []
    for i, d in enumerate(mesh.devices):
        rows = lay.upload(i, d).view(ns, L // 4)
        flo, fhi, fsm, fem = eng.fp.device_tensors(d)
        fl = _sk.staged_flags(flo, fhi, fsm, fem, rows, halo).reshape(-1)
        shards.append((d, rows, fl))
    cap = max(LANES, _pow2(ns // 8))
    while True:
        sel = [select_nonzero_words(fl, cap) for _, _, fl in shards]
        worst = max(s[0] for s in sel)
        if worst <= cap:
            break
        cap = min(ns, max(cap * 2, _pow2(worst)))
    totals = []
    for i, ((d, rows, _), (_, widx, _, live)) in enumerate(zip(shards, sel)):
        sid = torch.where(live, widx, -1).to(torch.int32).reshape(-1, 8, 128)
        lo, hi, sm, em = eng.full.device_tensors(d)
        counts, _ = _sk.staged_gathered(
            lo, hi, sm, em, eng.full.end_limbs, sid, rows, halo, lay.n0[i],
            lay.n1[i], False)
        totals.append(counts.sum())
    return _psum(totals, mesh)


def sharded_bitap_match_pairs(
    eng,  # ops.bitap.BitapEngine
    haystack: bytes,
    mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh-parallel match extraction: the full overlapping (pid, end)
    set, gathered across the mesh.

    Each device runs the extract-mode shift-AND kernel (G1) on its halo'd
    shard and compacts its own match words on the device
    (``select_nonzero_words``), so only O(#matches) data leaves each
    device; the per-shard results are stitched in shard order (ends are
    globally monotone across shards, preserving the reference's report
    order, util/search.rs:824-860). The count window makes each match
    reported by exactly one shard, the one owning its end.
    """
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size
    n = len(haystack)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # Bound each shard's end-words output (~4*K bytes per haystack byte)
    # as BitapEngine.match_pairs does: slab the haystack so each device's
    # shard stays within MAX_EXTRACT_CHUNK, with a max_pattern_len - 1
    # overlap between slabs; matches are deduped by end ownership.
    max_total = _bitap.MAX_EXTRACT_CHUNK * ndev
    if n > max_total:
        ov = eng.tables.max_pattern_len - 1
        all_pids, all_ends = [], []
        base = 0
        while base < n:
            hi_ = min(base + max_total, n)
            lo_ = max(0, base - ov)
            pids, ends = sharded_bitap_match_pairs(
                eng, haystack[lo_:hi_], mesh
            )
            keep = ends > (base - lo_)
            all_pids.append(pids[keep])
            all_ends.append(ends[keep] + lo_)
            base = hi_
        return np.concatenate(all_pids), np.concatenate(all_ends)
    t = eng.tables
    shard = _round_up(-(-n // ndev), 4)
    L, tiles = eng._layout(eng.halo + shard)
    lay = _Rows(haystack, ndev, shard, eng.halo, tiles * LANES * L)
    words_size = tiles * L * t.k * LANES
    flats = [_bitap_shard(eng, lay, i, d, L, tiles, True)[1].reshape(-1)
             for i, d in enumerate(mesh.devices)]
    # One cap for every shard, grown from the largest count (the kernels
    # are not launched again: the words stay on their devices).
    cap = 4096
    while True:
        sel = [select_nonzero_words(f, cap) for f in flats]
        worst = max(s[0] for s in sel)
        if worst <= cap:
            break
        cap = max(64, _pow2(worst))
    all_pids, all_ends = [], []
    for i, (_, idx, vals, _) in enumerate(sel):
        pids, ends = decode_match_words(
            t, idx.cpu().numpy(), vals.cpu().numpy().view(np.uint32), L, t.k,
            words_size,
        )
        all_pids.append(pids)
        all_ends.append(ends + lay.origin[i])
    return np.concatenate(all_pids), np.concatenate(all_ends)


def sharded_fp_match_pairs(
    eng,  # ops.fingerprint.FingerprintEngine
    haystack: bytes,
    mesh: Optional[Mesh] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Mesh-parallel fingerprint filtering: each device runs the masked
    bitmap kernel (G5) over its halo'd shard, its window the positions the
    shard owns, and selects its candidate positions on the device; the
    gathered candidates verify exactly against the full haystack on the
    host. Returns None when the workload is filter-hostile: when the
    shards' candidates, each counted once by its owner, pass the engine's
    limit. The engine's ``hostile`` flag is left as it was (the JAX
    function sets it): the caller's single-device fallback decides."""
    from ..ops import fingerprint as F

    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size
    n = len(haystack)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z
    t = eng.tables
    halo = eng.halo
    shard = _round_up(-(-n // ndev), 4)
    L, _, tiles = eng._layout(halo + shard)
    pad = t.pad_byte if t.pad_byte is not None else 0
    lay = _Rows(haystack, ndev, shard, halo, tiles * LANES * L, pad=pad)
    bmps = []
    for i, d in enumerate(mesh.devices):
        halo_a, body = _to_stream_major(lay.upload(i, d), L, tiles, halo)
        lo, hi, sm, em = t.device_tensors(d)
        bmps.append(_fk.fp_bitmap_generic(lo, hi, sm, em, halo_a, body,
                                          lay.n0[i], lay.n1[i])[1])
    cap = 4096
    while True:
        sel = [F._rank_select(b, L, cap) for b in bmps]
        if sum(s[0] for s in sel) > eng._hostile_limit(n):
            return None
        worst = max(s[0] for s in sel)
        if worst <= cap:
            break
        cap = max(64, _pow2(worst))
    cand = np.concatenate([
        e_pos[live].cpu().numpy() + lay.origin[i]
        for i, (_, e_pos, live) in enumerate(sel)
    ])
    if not len(cand):
        z = np.zeros(0, np.int64)
        return z, z
    a = np.frombuffer(haystack, np.uint8)
    if eng.ci:
        a = F._fold_arr(a)
    return eng.verif.verify(a, cand)


def sharded_cascade_match_pairs(
    eng,  # ops.cascade.CascadeEngine
    haystack: bytes,
    mesh: Optional[Mesh] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Mesh-parallel cascade search: the very-large-dictionary engine
    (10k-100k+ patterns) over a mesh.

    Unlike the bitap/fingerprint shards (backward halo: state warms up
    over the previous shard's tail), cascade candidates anchor at the
    COARSE PREFIX END — near the match *start* — and verification reads
    up to W bytes forward. Each shard therefore carries a small backward
    halo (kernel warmup) plus a W-byte FORWARD halo (its right
    neighbor's head), owns the candidates whose prefix ends inside its
    own region, and runs the probe/expand/verify stages locally. The
    coarse bitmap is G6 when the set has a strong pad byte (unmasked: the
    candidates outside the owned region are dropped after selection),
    else G5 with the owned region as its window. The hostility limit
    counts the owned candidates only, each once, as a single-device scan
    counts them. Caps are shared by the shards, grown from their largest
    counts, and local to the call, as is a hostile verdict (the engine's
    own caps and ``hostile`` flag are left as they are; the JAX function
    sets the flag). The pairs are gathered in shard order, duplicate
    exact-class patterns expanded by the engine's CSR
    (``CascadeEngine._host_pairs``), and sorted into report order.
    Returns None when hostile.

    Long-side patterns (> W_CASCADE bytes) are searched with the sharded
    bit-parallel path and merged in, mirroring the single-device engine.
    """
    from ..ops import cascade as C
    from ..ops import fingerprint as F

    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size
    n = len(haystack)
    z = np.zeros(0, np.int64)
    if n == 0:
        return z, z
    t = eng.tables
    halo = eng.halo
    W = t.W
    shard = _round_up(-(-n // ndev), 4)
    seg_bytes = halo + shard + _round_up(W, 4)
    L, tiles = eng._layout(seg_bytes)
    baked = eng.pad_byte is not None
    lay = _Rows(haystack, ndev, shard, halo, tiles * LANES * L,
                pad=eng.pad_byte or 0, fwd=W)
    shards = []
    for i, d in enumerate(mesh.devices):
        x32 = lay.upload(i, d)
        halo_a, body = _to_stream_major(x32, L, tiles, halo)
        dv = t.device_tensors(d)
        if baked:
            _, bmp = _fk.fp_bitmap_baked(*dv["coarse"], halo_a, body)
        else:
            _, bmp = _fk.fp_bitmap_generic(*dv["coarse"], halo_a, body,
                                           lay.n0[i], lay.n1[i])
        shards.append((dv, bmp, F._verify_buffer(x32, W, eng.ci)))
    cand_lim, exp_lim = eng._limits(n)
    cap_c = min(_pow2(max(seg_bytes // 4, 1024)), C.CAP0)
    cap_e, cap_m = cap_c, max(cap_c // 2, 1024)
    while True:
        ncands, owned, outs = [], [], []
        for i, (dv, bmp, u8f) in enumerate(shards):
            ncand, e_pos, live = F._rank_select(bmp, L, cap_c)
            if baked:
                live = live & (e_pos >= lay.n0[i]) & (e_pos < lay.n1[i])
            total, total_e, flags = C.verify_candidates(
                u8f, e_pos, live, lay.nv[i], t, dv, cap_e, True)
            outs.append((total_e, total) + select_matches(*flags, cap_m))
            ncands.append(ncand)
            # Exact where ncand fits the cap, else a lower bound (the
            # grown cap's pass then counts them all).
            owned.append(int(live.sum()) if baked else ncand)
        nes, totals = (np.array([int(o[k]) for o in outs]) for k in (0, 1))
        if sum(owned) > cand_lim or int(nes.sum()) > exp_lim:
            return None
        ok = True
        if max(ncands) > cap_c:
            cap_c = _pow2(max(ncands))
            ok = False
        if int(nes.max()) > cap_e:
            cap_e = _pow2(int(nes.max()))
            ok = False
        if int(totals.max()) > cap_m:
            cap_m = _pow2(int(totals.max()))
            ok = False
        if ok:
            break
    d0 = mesh.devices[0]
    pid = torch.cat([o[2].to(d0) for o in outs])
    end = torch.cat([(o[3] + lay.origin[i]).to(d0)
                     for i, o in enumerate(outs)])
    pid, end = eng._host_pairs(pid, end)
    if eng.side is not None:
        spids, sends = sharded_bitap_match_pairs(eng.side, haystack, mesh)
        pid = np.concatenate([pid, eng.long_pids[spids]])
        end = np.concatenate([end, sends])
    order = np.lexsort((eng.pid_rank[pid], end))
    return pid[order], end[order]


class ShardedSearcher:
    """A facade adapter that computes match sets across a mesh.

    Implements the minimal surface the stream machinery (stream.py)
    consumes — `_match_set` plus introspection — so sharded stream
    search/replace is the single-device code path running over
    mesh-gathered match sets (the reference's stream contract,
    automaton.rs:1036-1244, with the roll-buffer carry generalized to
    shard halos). Its route is its own, whatever ``engine=`` says: the
    bit-parallel engine where the set is in its bounds (counts take the
    staged engine where each shard holds STAGED_MIN bytes), else the
    fingerprint engine."""

    def __init__(self, ac, mesh: Optional[Mesh] = None):
        from ..utils.errors import MatchError

        self.ac = ac
        self.mesh = mesh if mesh is not None else make_mesh()
        self._eng = ac._engine("bitap")
        self._fp_eng = None
        if self._eng is None:
            # Pattern sets beyond the exact engine's bounds shard via
            # the fingerprint filter (verification host-side).
            self._fp_eng = ac._engine("fingerprint")
            if self._fp_eng is None:
                raise MatchError(
                    "unsupported-stream",
                    "sharded stream search requires a pattern set within"
                    " the bit-parallel or fingerprint engine's bounds",
                )

    # Introspection delegation (what stream.py consults).
    def match_kind(self):
        return self.ac.match_kind()

    def start_kind(self):
        return self.ac.start_kind()

    def max_pattern_len(self):
        return self.ac.max_pattern_len()

    def min_pattern_len(self):
        return self.ac.min_pattern_len()

    def patterns_len(self):
        return self.ac.patterns_len()

    def _match_set(self, input):
        from .. import semantics

        hs = input.haystack[input.start:input.end]
        if self._eng is not None:
            pids, ends = sharded_bitap_match_pairs(
                self._eng, hs, self.mesh
            )
        else:
            got = sharded_fp_match_pairs(self._fp_eng, hs, self.mesh)
            if got is None:  # filter-hostile: the facade's own route
                return self.ac._match_set(input)
            pids, ends = got
        starts = ends - self.ac._dfa.pattern_lens[pids].astype(np.int64)
        return semantics.MatchSet(pids, starts, ends, input.start)

    def count_matches(self, input) -> int:
        from ..utils.search import to_input

        input = to_input(input)
        if self._eng is None:
            return len(self._match_set(input).pids)
        hs = input.haystack[input.start:input.end]
        # Same engine preference as the single-device facade: the staged
        # two-stage count leads when the PER-SHARD size clears its
        # floor, so sharded large counts do not silently run a
        # different engine than single-device ones.
        staged = None
        if -(-len(hs) // self.mesh.size) >= _staged.STAGED_MIN:
            staged = self.ac._engine("staged")
        if staged is not None:
            return sharded_staged_count(staged, hs, self.mesh)
        return sharded_bitap_count(self._eng, hs, self.mesh)


def sharded_stream_replace_all(
    ac, reader, writer, replace_with, mesh: Optional[Mesh] = None,
    chunk_size: int = 1 << 20,
) -> None:
    """Stream replacement with the scan fanned out over the mesh.

    Chunks stream through ShardedSearcher's mesh-parallel extraction
    with the standard stream carry (tail + cursor); output is written
    in order, identical to the single-device stream_replace_all."""
    from ..stream import stream_replace_all

    stream_replace_all(
        ShardedSearcher(ac, mesh), reader, writer, replace_with,
        chunk_size,
    )
