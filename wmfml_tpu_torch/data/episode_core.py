"""The native episode core of the host path (``csrc/episode_core.cpp``), and
its plain numpy twins.

The port's counterpart of ``wmfml_tpu/_native/bindings.py``: the host-
streamed path's episodes are gathered by a multithreaded C++ core
(``assemble_episode``: the image rows; ``assemble_labels``: label rows;
``composite_backgrounds``: ShapeNet3D's splits on new backgrounds, in
place). The core is built at first use from the port's own source with the
host compiler (``$CXX``, else ``g++``) into ``wmfml_tpu_torch/_build/``
and loaded through ctypes. The library's name carries a hash of the source
and the flags, so a stale one is never loaded; each process builds into a
name of its own and ``os.replace``s it into place, so processes that build
at once (``pytest -n``) never load a half-written file.

Unlike the JAX package's bindings, nothing falls back to numpy: a core that
cannot be built raises ``RuntimeError`` at first use, on the CPU and on the
card alike. The numpy twins (``*_plain``: fancy indexing, and the
compositing arithmetic ``rgb fg + bg (1 - fg)``) are what the tests hold
the core against, bit for bit.

Threads: ``threads()``, half the host's cores (at least 1, at most 8). The
gather is bound by memory bandwidth, which a few threads fill; it runs on
the prefetch thread, which copies the batch into pinned memory (torch's
intra-op threads) only after it, and the other half of the cores stays with
the main thread, which issues the card's graph replays.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "csrc", "episode_core.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
ERRORS = {1: "the query views run past the permutation's columns",
          2: "an item, view or background index is out of range"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def threads() -> int:
    return max(1, min(8, (os.cpu_count() or 2) // 2))


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def lib_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libepisode_core_{digest.hexdigest()[:12]}.so")


def _build(path: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the episode core cannot be built: {cmd[0]!r}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the episode core failed to build ({' '.join(cmd)})"
                           f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The core, built first if this source's library is not there yet."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            common = [_i64, _i64, _i64, _i64p, _i64p, _i64, _i64, _i64, _i64,
                      _i64]
            lib.assemble_episode.argtypes = [_u8p, *common, _u8p, _u8p,
                                             ctypes.c_int]
            lib.assemble_labels.argtypes = [_f32p, *common, _f32p, _f32p]
            lib.composite_backgrounds.argtypes = [_f32p, _i64, _i64, _f32p,
                                                  _i64, _i64p, ctypes.c_int]
            for fn in (lib.assemble_episode, lib.assemble_labels,
                       lib.composite_backgrounds):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(rc: int, what: str):
    if rc != 0:
        raise ValueError(f"{what}: {ERRORS.get(rc, f'error {rc}')}")


def _query_start(shot: int, query_offset: int) -> int:
    return shot + query_offset if query_offset >= 0 else 0


def _flat(a: np.ndarray, dtype) -> np.ndarray:
    """``a``'s bytes as a flat C-contiguous array of ``dtype`` (a view)."""
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("the episode core reads and writes C-contiguous "
                         "arrays only")
    return a.reshape(-1).view(dtype)


def _indices(items, perm):
    return (np.ascontiguousarray(items, np.int64),
            np.ascontiguousarray(perm, np.int64))


def assemble_episode(data: np.ndarray, items: np.ndarray, perm: np.ndarray,
                     shot: int, query: int, query_offset: int = 0,
                     n_threads: Optional[int] = None,
                     out: Optional[Tuple[np.ndarray, np.ndarray]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The context rows ``data[items, perm[:, :shot]]`` [T, shot, ...] and
    the query rows ``data[items, perm[:, q0:q0 + query]]`` [T, query, ...]
    (q0 = shot + query_offset; 0 for ``query_offset`` -1, eval mode), as
    the JAX package's ``assemble_episode``. ``data`` [n_items, views, ...]
    of any dtype; ``perm`` [T, any number of columns]; ``out`` (ctx, qry):
    C-contiguous arrays of those shapes and ``data``'s dtype to write
    into (pinned memory, say) instead of new ones."""
    items, perm = _indices(items, perm)
    t, inner = items.shape[0], data.shape[2:]
    if out is None:
        out = (np.empty((t, shot) + inner, data.dtype),
               np.empty((t, query) + inner, data.dtype))
    ctx, qry = out
    for a, n in ((ctx, shot), (qry, query)):
        if a.shape != (t, n) + inner or a.dtype != data.dtype:
            raise ValueError(f"assemble_episode: an output of {a.shape} "
                             f"{a.dtype}, the episode needs "
                             f"{(t, n) + inner} {data.dtype}")
    row_bytes = int(np.prod(inner, dtype=np.int64)) * data.dtype.itemsize
    _check(load().assemble_episode(
        _flat(data, np.uint8), data.shape[0], data.shape[1], row_bytes,
        items, perm, perm.shape[1], t, shot, query, query_offset,
        _flat(ctx, np.uint8), _flat(qry, np.uint8),
        threads() if n_threads is None else n_threads), "assemble_episode")
    return ctx, qry


def assemble_labels(labels: np.ndarray, items: np.ndarray, perm: np.ndarray,
                    shot: int, query: int, query_offset: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``assemble_episode`` of float32 label rows [n_items, views, dim]."""
    items, perm = _indices(items, perm)
    labels = np.ascontiguousarray(labels, np.float32)
    t, dim = items.shape[0], labels.shape[2]
    ctx = np.empty((t, shot, dim), np.float32)
    qry = np.empty((t, query, dim), np.float32)
    _check(load().assemble_labels(
        _flat(labels, np.float32), labels.shape[0], labels.shape[1], dim,
        items, perm, perm.shape[1], t, shot, query, query_offset,
        _flat(ctx, np.float32), _flat(qry, np.float32)), "assemble_labels")
    return ctx, qry


def composite_backgrounds(images: np.ndarray, bg: np.ndarray,
                          bg_idx: np.ndarray, n_threads: Optional[int] = None):
    """RGBA float32 ``images`` [N, H, W, 4] on backgrounds ``bg[bg_idx %
    len(bg)]`` ([n_bg, H, W, 3]), in place: a pixel with alpha < 1 keeps
    its colour, any other takes the background's; alpha is kept."""
    n, h, w, _ = images.shape
    if bg.shape[1:] != (h, w, 3) or images.dtype != np.float32:
        raise ValueError(f"images {images.shape} {images.dtype}, backgrounds "
                         f"{bg.shape}: float32 RGBA on RGB of one size")
    _check(load().composite_backgrounds(
        _flat(images, np.float32), n, h * w,
        _flat(np.ascontiguousarray(bg, np.float32), np.float32), bg.shape[0],
        np.ascontiguousarray(bg_idx, np.int64),
        threads() if n_threads is None else n_threads),
        "composite_backgrounds")


def padded_views(perm: np.ndarray, shot: int, max_ctx: int, query: int,
                 query_offset: int = 0) -> np.ndarray:
    """[T, max_ctx + query] view indices of an episode padded to
    ``max_ctx``: the ``shot`` context views, then context view 0 again up
    to ``max_ctx`` (``data/episode.py:make_episode`` pads with context row
    0), then the query views (from ``perm[:, shot + query_offset]``, or
    ``perm[:, 0]`` with ``query_offset`` -1). ``assemble_episode(data,
    items, views, max_ctx, query)`` then gathers the padded episode in one
    pass."""
    if shot > max_ctx:
        raise ValueError(f"{shot} context rows > max_ctx {max_ctx}")
    q0 = _query_start(shot, query_offset)
    pad = np.repeat(perm[:, :1], max_ctx - shot, axis=1)
    return np.concatenate([perm[:, :shot], pad, perm[:, q0:q0 + query]],
                          axis=1)


class Rows:
    """The image rows ``data[items[:, None], views]`` of an episode, not
    gathered yet: ``shape`` and ``dtype`` are the gather's; ``gather(out)``
    runs the native core (into ``out``, a C-contiguous array, when given)
    under ``lock`` (``ShapeNet3DData``'s, against a recomposite of the
    split). The host path's trainer gathers them straight into the pinned
    memory it copies to the card (``train/trainer.py:_put_train_batch``)."""

    def __init__(self, data: np.ndarray, items: np.ndarray,
                 views: np.ndarray, lock=None):
        self.data, self.items, self.views = data, items, views
        self.lock = lock or contextlib.nullcontext()
        self.shape = items.shape[:1] + views.shape[1:2] + data.shape[2:]
        self.dtype = data.dtype

    def gather(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        n = self.views.shape[1]
        spare = np.empty((self.shape[0], 0) + self.shape[2:], self.dtype)
        with self.lock:
            return assemble_episode(
                self.data, self.items, self.views, n, 0,
                out=None if out is None else (out, spare))[0]


class NativeEpisodes:
    """``get_batch`` through the native core, for a host sampler whose
    splits hold ``images`` [items, views, ...] and per-view labels under
    ``LABELS``, drawn by its ``_draw(source, tasks, shot) -> (items, perm,
    shot)``, with ``max_ctx``, ``query_num`` and ``mode``. ``draw_batch``
    consumes the stream as ``get_batch`` does and returns the episode with
    its image rows as ``Rows`` (the context padded to ``max_ctx`` with
    context row 0, as ``data/episode.py:make_episode`` pads it; the
    queries from ``perm[:, shot]``, or ``perm[:, 0]`` in eval mode);
    ``get_batch`` gathers them."""

    LABELS = "Q"

    def draw_batch(self, source: str, tasks_per_batch: int,
                   shot: int) -> dict:
        split = self.splits[source]
        items, perm, shot = self._draw(source, tasks_per_batch, shot)
        s, q = self.max_ctx, self.query_num
        views = padded_views(perm, shot, s, q,
                             -1 if self.mode == "eval" else 0)
        labels = np.asarray(split[self.LABELS][items[:, None], views],
                            np.float32)
        mask = np.zeros((tasks_per_batch, s), dtype=bool)
        mask[:, :shot] = True
        lock = getattr(self, "_bg_lock", None)
        return dict(ctx_x=Rows(split["images"], items, views[:, :s], lock),
                    ctx_y=labels[:, :s], ctx_mask=mask,
                    qry_x=Rows(split["images"], items, views[:, s:], lock),
                    qry_y=labels[:, s:])

    def get_batch(self, source: str, tasks_per_batch: int, shot: int):
        return {k: v.gather() if isinstance(v, Rows) else v
                for k, v in self.draw_batch(source, tasks_per_batch,
                                            shot).items()}


# -- the plain twins ------------------------------------------------------------

def assemble_episode_plain(data, items, perm, shot, query, query_offset=0):
    """``assemble_episode`` by numpy fancy indexing."""
    q0 = _query_start(shot, query_offset)
    return (data[items[:, None], perm[:, :shot]],
            data[items[:, None], perm[:, q0:q0 + query]])


def assemble_labels_plain(labels, items, perm, shot, query, query_offset=0):
    return assemble_episode_plain(np.asarray(labels, np.float32), items, perm,
                                  shot, query, query_offset)


def composite_backgrounds_plain(images, bg, bg_idx):
    """``composite_backgrounds`` in numpy, in place (``rgb fg + bg (1 -
    fg)``, fg = alpha < 1: the same values on finite images)."""
    fg = (images[..., 3:4] < 1.0).astype(np.float32)
    images[..., :3] = (images[..., :3] * fg
                       + bg[bg_idx % bg.shape[0]] * (1.0 - fg))
