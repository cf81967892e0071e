"""Host-side input pipelines: the port's copy of
``msnets_tpu/data/pipeline.py`` (cropping, margins, sample assembly, the
shuffled, sharded, prefetched batch stream, the map-style dataset, and the
evaluator's padded test stream).

Hosts read images and produce *uint8 crops* (train) or *padded uint8 frames*
(test); the feature stage (``ops.features``) runs on the device.

Crop semantics (reference cbmv_generator.py:398-432, 581-638):
  * margins: board_w_left = max_disp (the unmatchable left band is cropped
    away after matching), board_w_right = 0 for left-only features and
    max_disp for left+right ones, board_h = 12;
  * random crop window [crop_h + 2*board_h, crop_w + bwl + bwr], with the
    margins halved for narrow images (ETH3D). The reference's halving loop
    never re-halves and would spin forever; here the margins halve
    progressively, which matches it in every case where it terminates;
  * GT disparity: crop, inf -> 0, margins removed -> [crop_h, crop_w] at
    full resolution.

Determinism: crops draw from a per-sample ``np.random.Generator`` seeded by
(seed, epoch, index), so the pipeline is reproducible and resumable.

Images are read with OpenCV, imported inside ``read_gray``/``read_rgb`` only:
a run that reads no image file needs no ``cv2``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import MatchingConfig
from . import pfm as pfmio
from . import resolvers


# ---------------------------------------------------------------------------
# image IO (monkeypatchable for tests / synthetic data)
# ---------------------------------------------------------------------------

def read_gray(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, 0)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, 1)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1].astype(np.uint8)  # BGR -> RGB


def image_width(path: str) -> int:
    """Image width from the file header without a full decode.

    PNG (all the reference datasets' image files) and PFM/PGM/PPM headers
    are sniffed directly (~tens of bytes); anything else falls back to a
    full ``read_gray``. Used by the geometry-bucketed batch scheduler,
    which needs per-entry crop geometry before loading any pixels."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        return int.from_bytes(head[16:20], "big")
    if head[:2] in (b"PF", b"Pf", b"P5", b"P6", b"P2", b"P3"):
        # whitespace/comment-tolerant: width is the first integer token
        # after the magic. PNM allows the whole header on ONE line
        # ("P5 640 480 255\n"), so tokenize the leading bytes rather than
        # assuming one field per line.
        with open(path, "rb") as f:
            buf = f.read(256)
        complete = len(buf) < 256              # whole file fit in the buffer
        tokens = []
        lines = buf.splitlines(keepends=True)
        for li, raw in enumerate(lines):
            line = raw.split(b"#", 1)[0]       # strip comments
            toks = line.split()
            if (toks and not complete and li == len(lines) - 1
                    and b"#" not in raw and not raw[-1:].isspace()):
                # a token cut at the buffer boundary parses as a TRUNCATED
                # number (e.g. "64" of "640" after long header comments) —
                # only trust tokens terminated by a delimiter inside the
                # buffer; otherwise fall through to read_gray
                toks = toks[:-1]
            tokens.extend(toks)
            if len(tokens) >= 2:
                return int(tokens[1])
    return read_gray(path).shape[1]


# ---------------------------------------------------------------------------
# crop geometry
# ---------------------------------------------------------------------------

def crop_position(w: int, h: int, crop_w: int, crop_h: int,
                  board_w_left: int, board_w_right: int, board_h: int,
                  rng: Optional[np.random.Generator],
                  fixed_center: bool = False):
    """(start_w, start_h, finish_w, finish_h, bwl, bwr); see module docstring.

    Mirrors get_crop_position (cbmv_generator.py:398-432).
    """
    bwl, bwr = board_w_left, board_w_right
    while w - crop_w - bwl - bwr < 0:
        if bwl == 0 and bwr == 0:
            raise ValueError(f"image width {w} < crop width {crop_w}")
        bwl //= 2
        bwr //= 2
    if fixed_center:
        start_w = max((w - crop_w - bwl - bwr) // 2 - 1, 0)
        start_h = max((h - crop_h - 2 * board_h) // 2 - 1, 0)
    else:
        start_w = int(rng.integers(0, w - crop_w - bwl - bwr + 1))
        start_h = int(rng.integers(0, h - crop_h - 2 * board_h + 1))
    finish_h = start_h + crop_h + 2 * board_h
    finish_w = start_w + crop_w + bwl + bwr
    return start_w, start_h, finish_w, finish_h, bwl, bwr


def _remove_border(a: np.ndarray, board_h: int, bwl: int, bwr: int) -> np.ndarray:
    h_end = -board_h if board_h > 0 else None
    w_end = -bwr if bwr > 0 else None
    return np.ascontiguousarray(a[board_h:h_end, bwl:w_end])


# ---------------------------------------------------------------------------
# samples
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainSample:
    """Host output for one training example. Images still carry the margins;
    the device feature stage trims them (scaled by ds_scale)."""
    iml: np.ndarray          # uint8 [crop_h + 2*bh, crop_w + bwl + bwr]
    imr: np.ndarray          # uint8, same shape
    disp: np.ndarray         # float32 [crop_h, crop_w] full-res GT
    left_rgb: np.ndarray     # float32 [3, crop_h, crop_w] in [0, 1]
    right_rgb: np.ndarray    # float32 [3, crop_h, crop_w]
    board_h: int
    board_w_left: int
    board_w_right: int

@dataclasses.dataclass
class TestSample:
    iml: np.ndarray          # uint8 [crop_h, crop_w] padded full-res
    imr: np.ndarray
    height: int              # original image dims
    width: int
    crop_height: int         # padded dims (multiple of encoder_ds)
    crop_width: int
    entry: str
    disp_path: str


def make_train_sample(limg: str, rimg: str, ldisp: str,
                      crop_h: int, crop_w: int, max_disp: int,
                      cfg: MatchingConfig,
                      rng: Optional[np.random.Generator] = None,
                      fixed_center: bool = False,
                      left_only: bool = True) -> TrainSample:
    """Read + crop one training pair (generate_crop_train_cbmv semantics,
    minus the feature stage which runs on device)."""
    # each file is decoded twice (gray + RGB) ON PURPOSE: the reference
    # does exactly this (cbmv_generator.py:610-613), and cv2.imread(p, 0)'s
    # decoder-level grayscale is not bit-identical to cvtColor of the BGR
    # decode — deriving gray from the RGB read would break matcher parity.
    # The prefetch threads hide the extra decode.
    iml = read_gray(limg)
    imr = read_gray(rimg)
    iml_rgb = read_rgb(limg)
    imr_rgb = read_rgb(rimg)
    h, w = iml.shape
    bwl = max_disp
    bwr = 0 if left_only else max_disp
    sw, sh, fw, fh, bwl, bwr = crop_position(
        w, h, crop_w, crop_h, bwl, bwr, cfg.board_h, rng, fixed_center)

    disp = pfmio.read_pfm(ldisp)
    disp = disp[sh:fh, sw:fw].copy()
    disp[disp == np.inf] = 0.0
    disp = _remove_border(disp, cfg.board_h, bwl, bwr)

    def crop_rgb(img):
        c = _remove_border(img[sh:fh, sw:fw], cfg.board_h, bwl, bwr)
        return np.ascontiguousarray(c.transpose(2, 0, 1)).astype(np.float32) / 255.0

    return TrainSample(
        iml=np.ascontiguousarray(iml[sh:fh, sw:fw]),
        imr=np.ascontiguousarray(imr[sh:fh, sw:fw]),
        disp=disp.astype(np.float32),
        left_rgb=crop_rgb(iml_rgb),
        right_rgb=crop_rgb(imr_rgb),
        board_h=cfg.board_h, board_w_left=bwl, board_w_right=bwr)


def make_dummy_train_sample(crop_h: int, crop_w: int, max_disp: int,
                            cfg: MatchingConfig,
                            left_only: bool = True) -> TrainSample:
    """Shape-correct synthetic fixture (generate_dummy_crop_train_cbmv,
    cbmv_generator.py:508-545): constant-64 disparity, zero images."""
    bh, bwl = cfg.board_h, max_disp
    bwr = 0 if left_only else max_disp
    shape = (crop_h + 2 * bh, crop_w + bwl + bwr)
    return TrainSample(
        iml=np.zeros(shape, np.uint8), imr=np.zeros(shape, np.uint8),
        disp=np.full((crop_h, crop_w), 64.0, np.float32),
        left_rgb=np.zeros((3, crop_h, crop_w), np.float32),
        right_rgb=np.zeros((3, crop_h, crop_w), np.float32),
        board_h=bh, board_w_left=bwl, board_w_right=bwr)


def make_test_sample(limg: str, rimg: str, ldisp: str, entry: str,
                     encoder_ds: int = 32) -> TestSample:
    """Pad top and right to a multiple of encoder_ds (generate_test_cbmv,
    cbmv_generator.py:780-788). Downsample and border pad run on the
    device."""
    iml = read_gray(limg)
    imr = read_gray(rimg)
    h, w = iml.shape
    cw = w + (encoder_ds - w % encoder_ds) % encoder_ds
    ch = h + (encoder_ds - h % encoder_ds) % encoder_ds
    pad_h, pad_w = ch - h, cw - w
    iml = np.pad(iml, ((pad_h, 0), (0, pad_w)))
    imr = np.pad(imr, ((pad_h, 0), (0, pad_w)))
    return TestSample(iml=iml, imr=imr, height=h, width=w,
                      crop_height=ch, crop_width=cw, entry=entry,
                      disp_path=ldisp)


def synthetic_train_batch(crop_h: int, crop_w: int, max_disp: int,
                          cfg: MatchingConfig, batch_size: int, shift: int,
                          seed: int, left_only: bool = True) -> dict:
    """A batch as ``TrainPipeline.epoch`` yields it (without the RGB crops)
    of textured pairs with a known disparity: each left crop is a seeded
    uniform-random texture, its right crop the same texture ``shift`` px
    further right (left[x] = right[x - shift]), the target ``shift``
    everywhere; margins as ``make_train_sample`` sets them."""
    bh, bwl = cfg.board_h, max_disp
    bwr = 0 if left_only else max_disp
    h, w = crop_h + 2 * bh, crop_w + bwl + bwr
    base = np.random.default_rng(seed).integers(
        0, 256, (batch_size, h, w + shift), dtype=np.uint8)
    return {"iml": np.ascontiguousarray(base[:, :, :w]),
            "imr": np.ascontiguousarray(base[:, :, shift:]),
            "disp": np.full((batch_size, crop_h, crop_w), float(shift),
                            np.float32),
            "board_h": bh, "board_w_left": bwl, "board_w_right": bwr}



# ---------------------------------------------------------------------------
# dataset iterators with thread prefetching
# ---------------------------------------------------------------------------

class TrainPipeline:
    """Deterministic, shuffled, thread-prefetched training stream.

    Replaces the reference's DataLoader worker processes + per-epoch process
    restarts. Feature extraction is NOT done here: batches carry uint8
    image crops, and the train step computes features on the device.

    Sharding: with (num_hosts, host_id) each host takes the first
    ``len(entries) // num_hosts`` entries of ``perm[host_id::num_hosts]`` —
    equal shard length on every host (required: all hosts must take the
    same number of steps or the collectives hang), with the
    per-epoch permutation rotating which remainder entries drop, so all
    files are covered within a few epochs (the reference's contiguous
    split drops the SAME N mod workers files every epoch,
    dataset.py:349-357).

    Multi-host geometry lockstep assumes a SHARED FILESYSTEM: building the
    batch schedule header-sniffs every host's left images (~64 bytes each,
    never pixel data) so all hosts derive the identical batch sequence.
    With host-local data shards the schedule build raises a
    FileNotFoundError naming this assumption.
    """

    def __init__(self, data_cfg, match_cfg: MatchingConfig,
                 crop_h: int, crop_w: int, max_disp: int,
                 batch_size: int, seed: int = 1234,
                 num_threads: int = 4, num_hosts: int = 1, host_id: int = 0,
                 fixed_center: bool = False):
        self.data_cfg = data_cfg
        self.cfg = match_cfg
        self.crop_h, self.crop_w, self.max_disp = crop_h, crop_w, max_disp
        self.batch_size = batch_size
        self.seed = seed
        self.num_threads = num_threads
        self.num_hosts, self.host_id = num_hosts, host_id
        self.fixed_center = fixed_center
        self.entries = resolvers.load_list(data_cfg.training_list)
        self.cleanpass = match_cfg.sf_frames_type == "frames_cleanpass"
        self.left_only = match_cfg.left_only
        self._width_cache: dict = {}

    def steps_per_epoch(self) -> int:
        """Upper bound (len // batch, the reference's get_dataloader_len,
        funcs_utili.py:139-146); exact for single-geometry datasets. Mixed
        geometries (narrow ETH3D images among wide ones) may drop one
        partial bucket per geometry — ``len(self.batch_schedule(epoch))``
        is the exact count for a given epoch."""
        n = len(self.entries) // self.num_hosts
        return n // self.batch_size

    def shard_entries(self, epoch: int) -> List[str]:
        """This host's equal-length entry shard for one epoch (the per-epoch
        permutation rotates which remainder entries drop — see class doc)."""
        perm_rng = np.random.default_rng((self.seed, epoch))
        perm = perm_rng.permutation(len(self.entries))
        per_host = len(self.entries) // max(self.num_hosts, 1)
        shard = perm[self.host_id::self.num_hosts][:per_host]
        return [self.entries[i] for i in shard]

    def load_entry(self, entry: str, epoch: int, index: int) -> TrainSample:
        """Load one sample by (entry, epoch, index) — the single definition
        of sample construction shared by the stream and MapDataset (the
        (seed, epoch, index) rng key IS the ds[i] == streamed[i] contract)."""
        paths = resolvers.resolve(self.data_cfg.dataset, self.data_cfg.data_path,
                                  entry, self.cleanpass)
        rng = np.random.default_rng((self.seed, epoch, index))
        return make_train_sample(paths[0], paths[1], paths[2],
                                 self.crop_h, self.crop_w, self.max_disp,
                                 self.cfg, rng, self.fixed_center,
                                 left_only=self.left_only)

    def _load(self, epoch: int, index: int) -> TrainSample:
        return self.load_entry(self._epoch_entries[index], epoch, index)

    # -- geometry-bucketed batch schedule ---------------------------------
    def geometry_for_width(self, w: int) -> Tuple[int, int, int]:
        """(board_h, bwl, bwr) crop_position would produce for image width
        ``w`` — the margin-halving loop is a pure function of the width."""
        bwl = self.max_disp
        bwr = 0 if self.left_only else self.max_disp
        while w - self.crop_w - bwl - bwr < 0:
            if bwl == 0 and bwr == 0:
                raise ValueError(f"image width {w} < crop width {self.crop_w}")
            bwl //= 2
            bwr //= 2
        return (self.cfg.board_h, bwl, bwr)

    def _entry_geometry(self, entry: str) -> Tuple[int, int, int]:
        paths = resolvers.resolve(self.data_cfg.dataset,
                                  self.data_cfg.data_path, entry,
                                  self.cleanpass)
        w = self._width_cache.get(paths[0])
        if w is None:
            w = image_width(paths[0])
            self._width_cache[paths[0]] = w
        return self.geometry_for_width(w)

    def batch_schedule(self, epoch: int,
                       entries: Optional[List[str]] = None):
        """The epoch's batches as (geometry, [sample indices]) in yield order.

        Samples are assigned to per-geometry buckets in shard order; a
        bucket that reaches ``batch_size`` becomes the next batch. Narrow
        images (whose margins halve, cbmv_generator.py:409-419) therefore
        batch with each other instead of failing the mixed-geometry check —
        the reference never batches narrow images at all (ETH3D trains at
        batch 1 there). Partial buckets at epoch end drop (drop_last
        semantics, main_msnet.py:98-105). Deterministic given (seed, epoch):
        geometry needs only each entry's image width (header sniff, cached
        across epochs) — never pixel data — so mid-epoch resume can skip
        batches without loading them."""
        if entries is None:
            entries = self.shard_entries(epoch)
        geoms = [self._entry_geometry(e) for e in entries]
        if len(set(geoms)) == 1 and self.num_hosts == 1:
            # single host, single geometry (every reference dataset but
            # mixed/narrow ones): contiguous batches, no bookkeeping
            g0 = geoms[0]
            n = len(entries) // self.batch_size
            return [(g0, list(range(b * self.batch_size,
                                    (b + 1) * self.batch_size)))
                    for b in range(n)]

        def bucketize(gs):
            """{geometry: [[idx batch], ...]} in shard order."""
            buckets: dict = {}
            done: dict = {}
            for i, g in enumerate(gs):
                b = buckets.setdefault(g, [])
                b.append(i)
                if len(b) == self.batch_size:
                    done.setdefault(g, []).append(list(b))
                    b.clear()
            return done

        if self.num_hosts == 1:
            # preserve shard-order interleaving of geometries
            buckets: dict = {}
            schedule = []
            for i, g in enumerate(geoms):
                b = buckets.setdefault(g, [])
                b.append(i)
                if len(b) == self.batch_size:
                    schedule.append((g, list(b)))
                    b.clear()
            return schedule
        mine = bucketize(geoms)
        # multi-host: every host must enter the SAME SEQUENCE of
        # steps — same count AND same geometry per step (each geometry
        # gives other shapes; mismatched shapes at one step hang the
        # collectives just like mismatched counts). Build a
        # canonical sequence every host derives identically: per-geometry
        # batch counts are truncated to the minimum across hosts (each host
        # can compute every host's shard — the permutation is (seed, epoch)
        # -deterministic and widths come from the shared filesystem), then
        # batches run grouped by sorted geometry key.
        perm = np.random.default_rng(
            (self.seed, epoch)).permutation(len(self.entries))
        per_host = len(self.entries) // self.num_hosts
        min_counts = {g: len(bs) for g, bs in mine.items()}
        for h in range(self.num_hosts):
            if h == self.host_id:
                continue
            sh = [self.entries[i] for i in perm[h::self.num_hosts][:per_host]]
            try:
                theirs = bucketize([self._entry_geometry(e) for e in sh])
            except FileNotFoundError as e:
                raise FileNotFoundError(
                    f"multi-host batch_schedule: host {self.host_id} cannot "
                    f"header-sniff host {h}'s image {e.filename!r}. Geometry "
                    "lockstep assumes every host sees ALL hosts' image files "
                    "on a shared filesystem (only ~64-byte header reads); "
                    "with host-local data shards, make the file listing "
                    "visible to every host or use a single-geometry "
                    "dataset list.") from e
            for g in list(min_counts):
                min_counts[g] = min(min_counts[g], len(theirs.get(g, [])))
        schedule = []
        for g in sorted(min_counts):
            schedule.extend((g, b) for b in mine[g][:min_counts[g]])
        return schedule

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[dict]:
        """Yield batches of stacked host arrays for one epoch.

        ``start_batch`` skips the first N batches WITHOUT loading them —
        every sample is keyed by (seed, epoch, index) and the batch
        schedule is a pure function of (seed, epoch, entry widths), so
        resuming an interrupted epoch at batch N replays exactly the
        batches an uninterrupted run would have seen (step-granular
        recovery; the reference's recovery granularity is a whole epoch,
        do_main_msnet.sh:143-192).

        Batches follow ``batch_schedule``: geometry-bucketed, so datasets
        mixing narrow (margin-halved) and wide images train at batch > 1 —
        each batch is single-geometry by construction."""
        # equal shard length on every host (len // num_hosts): with uneven
        # strided shards one host would run extra steps the others
        # never enter — on a real multi-process run the collectives of
        # that step block forever. Coverage across epochs is preserved by
        # the per-epoch permutation (different entries drop each epoch).
        self._epoch_entries = self.shard_entries(epoch)
        schedule = self.batch_schedule(epoch, self._epoch_entries)

        from collections import OrderedDict
        from concurrent.futures import ThreadPoolExecutor
        # bounded look-ahead: an epoch of Scene Flow is ~35k samples x
        # ~4 MB — submitting everything up front (and keeping consumed
        # futures alive) would grow host RSS toward 140 GB. The window
        # keeps at most `ahead` loads in flight / cached, and consumed
        # futures are popped so their samples free immediately.
        ahead = max(self.num_threads * 2, self.batch_size * 2)
        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            futures: "OrderedDict[int, object]" = OrderedDict()
            it = iter(i for _, idxs in schedule[start_batch:] for i in idxs)

            def top_up():
                while len(futures) < ahead:
                    i = next(it, None)
                    if i is None:
                        return
                    futures[i] = ex.submit(self._load, epoch, i)

            top_up()
            for g0, idxs in schedule[start_batch:]:
                samples = [futures.pop(i).result() for i in idxs]
                top_up()
                for s in samples:
                    g = (s.board_h, s.board_w_left, s.board_w_right)
                    # sanity: the width-derived schedule geometry must match
                    # what make_train_sample actually produced
                    assert g == g0, (
                        f"schedule geometry {g0} != loaded geometry {g}")
                yield {
                    "iml": np.stack([s.iml for s in samples]),
                    "imr": np.stack([s.imr for s in samples]),
                    "disp": np.stack([s.disp for s in samples]),
                    "left_rgb": np.stack([s.left_rgb for s in samples]),
                    "right_rgb": np.stack([s.right_rgb for s in samples]),
                    "board_h": g0[0],
                    "board_w_left": g0[1],
                    "board_w_right": g0[2],
                }


class MapDataset:
    """Map-style random-access training dataset (the reference's
    DatasetFromList, src/dataloader/dataset.py:124-215): ``__len__`` +
    ``__getitem__`` over this host's shard of one epoch.

    A thin re-expression of TrainPipeline._load: ``ds[i]`` returns exactly
    the sample the streamed TrainPipeline would place at position ``i`` of
    the same epoch (same (seed, epoch, index) crop RNG, same shard
    permutation) — parity asserted by
    tests/test_data.py::test_map_dataset_matches_streamed_order. Index with
    ``ds[i]`` for the bound epoch, or ``ds[(epoch, i)]`` for any epoch."""

    def __init__(self, pipeline: TrainPipeline, epoch: int = 1):
        self.pipe = pipeline
        self.epoch = epoch
        self._shards = {epoch: pipeline.shard_entries(epoch)}

    def __len__(self) -> int:
        return len(self._shards[self.epoch])

    def __getitem__(self, key) -> TrainSample:
        epoch, index = key if isinstance(key, tuple) else (self.epoch, key)
        if epoch not in self._shards:
            self._shards[epoch] = self.pipe.shard_entries(epoch)
        entries = self._shards[epoch]
        if not -len(entries) <= index < len(entries):
            raise IndexError(index)
        index %= len(entries)
        return self.pipe.load_entry(entries[index], epoch, index)


class TestPipeline:
    """Sequential eval stream (batch 1, like the reference test loader)."""

    def __init__(self, data_cfg, match_cfg: MatchingConfig, encoder_ds: int = 32):
        self.data_cfg = data_cfg
        self.cfg = match_cfg
        self.encoder_ds = encoder_ds
        self.entries = resolvers.load_list(data_cfg.test_list)
        self.cleanpass = match_cfg.sf_frames_type == "frames_cleanpass"

    def __len__(self):
        return len(self.entries)

    def __iter__(self) -> Iterator[TestSample]:
        for entry in self.entries:
            paths = resolvers.resolve(self.data_cfg.dataset,
                                      self.data_cfg.data_path, entry,
                                      self.cleanpass)
            yield make_test_sample(paths[0], paths[1], paths[2], entry,
                                   self.encoder_ds)
