"""The port's native episode core (``data/episode_core.py``,
``csrc/episode_core.cpp``) on the CPU.

``assemble_episode`` (uint8 and float32 rows; train mode and eval mode,
``query_offset`` -1; 1, 3 and the default number of threads),
``assemble_labels`` and ``composite_backgrounds`` bit for bit against their
numpy twins and the JAX package's ``wmfml_tpu._native.bindings`` (its
compiled core); the padded one-pass gather against ``make_episode``'s
padding; whole ``get_batch`` calls of ShapeNet3D and Distractor through
the core against the JAX samplers on one seed; the core's checks; its
build by several processes at once; and no fallback: a core that cannot
be built raises, in the data modules too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from wmfml_tpu._native import bindings as jax_native
from wmfml_tpu.data.shapenet_3d import ShapeNet3DData as JaxShapeNet3D
from wmfml_tpu.data.shapenet_distractor import ShapeNetDistractor as JaxDistractor
from wmfml_tpu_torch.data import episode_core as core
from wmfml_tpu_torch.data import shapenet_3d, shapenet_distractor, synthetic
from wmfml_tpu_torch.data.episode import make_episode
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 16


def _split(dtype, n_items=7, views=12, shape=(HW, HW, 1), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (n_items, views, *shape)).astype(np.uint8)
    return rng.rand(n_items, views, *shape).astype(np.float32)


def _draw(n_items, views, tasks=5, seed=1):
    rng = np.random.RandomState(seed)
    items = rng.randint(0, n_items, tasks).astype(np.int64)
    perm = np.stack([rng.permutation(views) for _ in range(tasks)])
    return items, perm.astype(np.int64)


def _jax_lib():
    lib = jax_native.load()
    assert lib is not None, "the JAX package's native core did not build"
    return lib


@pytest.mark.parametrize("n_threads", [1, 3, None])
@pytest.mark.parametrize("shot,query,offset", [(4, 6, 0), (2, 5, 1),
                                               (3, 12, -1)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_assemble_episode_matches_its_twin_and_jax(dtype, shot, query, offset,
                                                   n_threads):
    data = _split(dtype, shape=(HW, HW, 4) if dtype == np.float32
                  else (HW, HW, 1))
    items, perm = _draw(*data.shape[:2])
    got = core.assemble_episode(data, items, perm, shot, query, offset,
                                n_threads=n_threads)
    plain = core.assemble_episode_plain(data, items, perm, shot, query,
                                        offset)
    _jax_lib()
    jx = jax_native.assemble_episode(data, items, perm, shot, query,
                                     query_offset=offset)
    for g, p, j in zip(got, plain, jx):
        assert g.dtype == data.dtype and g.flags["C_CONTIGUOUS"]
        assert g.shape == p.shape == j.shape
        assert np.array_equal(g, p) and np.array_equal(g, j)


@pytest.mark.parametrize("shot,query,offset", [(4, 6, 0), (3, 12, -1)])
def test_assemble_labels_matches_its_twin_and_jax(shot, query, offset):
    labels = _split(np.float32, shape=(4,))
    items, perm = _draw(*labels.shape[:2])
    got = core.assemble_labels(labels, items, perm, shot, query, offset)
    plain = core.assemble_labels_plain(labels, items, perm, shot, query,
                                       offset)
    lib = _jax_lib()
    t = items.shape[0]
    jx = (np.empty((t, shot, 4), np.float32), np.empty((t, query, 4),
                                                       np.float32))
    assert lib.assemble_labels(labels.reshape(-1), *labels.shape[:2], 4,
                               items, perm, t, shot, query, offset,
                               jx[0].reshape(-1), jx[1].reshape(-1)) == 0
    for g, p, j in zip(got, plain, jx):
        assert np.array_equal(g, p) and np.array_equal(g, j)


@pytest.mark.parametrize("n_threads", [1, 4, None])
def test_composite_backgrounds_matches_its_twin_and_jax(n_threads):
    rng = np.random.RandomState(3)
    images = rng.rand(9, HW, HW, 4).astype(np.float32)
    images[..., 3] = np.where(rng.rand(9, HW, HW) > 0.5, 1.0,
                              rng.rand(9, HW, HW) * 0.99).astype(np.float32)
    bg = rng.rand(5, HW, HW, 3).astype(np.float32)
    idx = rng.randint(0, 200, 9).astype(np.int64)      # taken % 5
    got, plain, jx = images.copy(), images.copy(), images.copy()
    core.composite_backgrounds(got, bg, idx, n_threads=n_threads)
    core.composite_backgrounds_plain(plain, bg, idx)
    _jax_lib()
    jax_native.composite_backgrounds(jx, bg, idx)
    assert np.array_equal(got, plain) and np.array_equal(got, jx)
    assert np.array_equal(got[..., 3], images[..., 3])
    assert not np.array_equal(got, images)


@pytest.mark.parametrize("shot,offset", [(1, 0), (3, 0), (5, 0), (2, -1),
                                         (5, -1)])
def test_padded_gather_equals_make_episode(shot, offset):
    """One gather over ``padded_views`` gives ``make_episode``'s padded
    episode (context row 0 repeated up to max_ctx) bit for bit."""
    data = _split(np.uint8)
    labels = _split(np.float32, shape=(2,))
    items, perm = _draw(*data.shape[:2])
    max_ctx, query = 5, 6 if offset >= 0 else 12
    want = make_episode(
        *core.assemble_episode_plain(data, items, perm, shot, query,
                                     offset)[:1],
        labels[items[:, None], perm[:, :shot]],
        core.assemble_episode_plain(data, items, perm, shot, query,
                                    offset)[1],
        core.assemble_episode_plain(labels, items, perm, shot, query,
                                    offset)[1], max_ctx=max_ctx, shot=shot)
    views = core.padded_views(perm, shot, max_ctx, query, offset)
    ctx_x, qry_x = core.assemble_episode(data, items, views, max_ctx, query)
    ys = labels[items[:, None], views]
    got = make_episode(ctx_x, ys[:, :max_ctx], qry_x, ys[:, max_ctx:],
                       max_ctx=max_ctx, shot=shot)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError):
        core.padded_views(perm, max_ctx + 1, max_ctx, query, offset)


def test_the_core_refuses_what_it_cannot_gather():
    data = _split(np.float32)
    items, perm = _draw(*data.shape[:2])
    with pytest.raises(ValueError, match="past"):
        core.assemble_episode(data, items, perm, 6, 7)     # 13 > 12 views
    bad = items.copy()
    bad[2] = data.shape[0]
    with pytest.raises(ValueError, match="out of range"):
        core.assemble_episode(data, bad, perm, 4, 6)
    bad = perm.copy()
    bad[1, 0] = -1
    with pytest.raises(ValueError, match="out of range"):
        core.assemble_labels(data[..., 0, 0, 0:1], items, bad, 4, 6)
    with pytest.raises(ValueError, match="contiguous"):
        core.assemble_episode(data[:, ::2], items, perm[:, :6], 2, 3)
    images = np.ones((2, HW, HW, 4), np.float32)
    with pytest.raises(ValueError, match="out of range"):
        core.composite_backgrounds(images, np.zeros((3, HW, HW, 3),
                                                    np.float32),
                                   np.array([0, -1]))


@pytest.fixture(scope="module")
def s3d_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet3d"))
    synthetic.generate_shapenet3d(root, small=True)
    return root


@pytest.fixture(scope="module")
def distractor_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("distractor"))
    synthetic.generate_distractor(root)
    return root


def _counting(monkeypatch):
    """Record the rows each call of the core's ``assemble_episode`` gathers
    (its ``shot`` + ``query``)."""
    calls, gather = [], core.assemble_episode

    def counted(*args, **kwargs):
        calls.append(args[3] + args[4])
        return gather(*args, **kwargs)

    monkeypatch.setattr(core, "assemble_episode", counted)
    return calls


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_shapenet3d_get_batch_runs_the_core_as_jax(s3d_dir, mode,
                                                   monkeypatch):
    """Whole ``get_batch`` calls of every split, the core gathering the
    padded episode, against the JAX sampler (its native core) bit for bit,
    before and after a recomposite of every split through the core (under
    the sampler's lock) on the same stream as JAX's."""
    calls = _counting(monkeypatch)
    max_ctx = 15 if mode == "train" else 25
    common = dict(img_size=[64, 64, 4], seed=42, max_ctx=max_ctx, mode=mode)
    port = shapenet_3d.ShapeNet3DData(s3d_dir, **common)
    jx = JaxShapeNet3D(s3d_dir, **common)
    sources = (["train"] if mode == "train" else []) + ["validation", "test"]
    for _ in range(2):
        for source in sources:
            for shot in (1, max_ctx):
                got = port.get_batch(source, 3, shot)
                want = jx.get_batch(source, 3, shot)
                assert got.keys() == want.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype, (source, k)
                    assert np.array_equal(got[k], want[k]), (source, k)
        # the same recomposite on both, from equal streams
        locked = []
        lock = port._bg_lock

        class Recording:
            def __enter__(self):
                locked.append(True)
                return lock.__enter__()

            def __exit__(self, *exc):
                return lock.__exit__(*exc)

        port._bg_lock = Recording()
        for name in port.splits:
            port._composite_split(name, np.random.RandomState(7))
            jx._composite_split(name, np.random.RandomState(7))
            assert np.array_equal(port.splits[name]["images"],
                                  jx.splits[name]["images"])
        port._bg_lock = lock
        assert len(locked) == len(port.splits)
    # a get_batch gathers its context rows, then its query rows
    query = 15 if mode == "train" else 30
    assert calls == [max_ctx, query] * (2 * 2 * len(sources))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_distractor_get_batch_runs_the_core_as_jax(distractor_dir, mode,
                                                   monkeypatch):
    calls = _counting(monkeypatch)
    max_ctx = 15 if mode == "train" else 25
    common = dict(img_size=[128, 128, 1], seed=42, max_ctx=max_ctx,
                  mode=mode, load_test_categ_only=mode == "eval")
    port = shapenet_distractor.ShapeNetDistractor(distractor_dir, **common)
    jx = JaxDistractor(distractor_dir, **common)
    for source in ("train", "validation", "test", "test"):
        for shot in (1, max_ctx):
            got = port.get_batch(source, 3, shot)
            want = jx.get_batch(source, 3, shot)
            for k in want:
                assert got[k].dtype == want[k].dtype, (source, k)
                assert np.array_equal(got[k], want[k]), (source, k)
    query = 18 if mode == "train" else 36
    assert calls == [max_ctx, query] * 8


def test_no_fallback_when_the_core_cannot_be_built(tmp_path, monkeypatch,
                                                   s3d_dir, distractor_dir):
    """A compiler that is not there: the core raises at first use, and so
    do both samplers' ``get_batch`` and ShapeNet3D's recomposite; nothing
    falls back to numpy."""
    port3d = shapenet_3d.ShapeNet3DData(s3d_dir, img_size=[64, 64, 4],
                                        seed=42)
    portd = shapenet_distractor.ShapeNetDistractor(
        distractor_dir, img_size=[128, 128, 1], seed=42)
    monkeypatch.setattr(core, "_lib", None)
    monkeypatch.setattr(core, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    for call in (lambda: core.assemble_episode(*_pair_args()),
                 lambda: port3d.get_batch("train", 2, 3),
                 lambda: portd.get_batch("validation", 2, 3),
                 lambda: port3d.gen_bg(_Logged(), "train")):
        with pytest.raises(RuntimeError, match="cannot be built"):
            call()
    assert core._lib is None
    assert not os.listdir(tmp_path / "build")


def _pair_args():
    data = _split(np.uint8)
    items, perm = _draw(*data.shape[:2])
    return data, items, perm, 3, 4


class _Logged:
    class logger:
        @staticmethod
        def info(msg):
            pass


def test_processes_building_at_once_load_one_library(tmp_path):
    """Four processes build the core into an empty directory at once (as
    ``pytest -n`` workers do): each loads it and gathers right, one library
    is left and no temporary file."""
    build = str(tmp_path / "build")
    code = (
        "import sys, numpy as np\n"
        "from wmfml_tpu_torch.data import episode_core as core\n"
        "core.BUILD_DIR = sys.argv[1]\n"
        "d = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)\n"
        "c, q = core.assemble_episode(d, np.array([1]), np.array([[2, 0, 1]]),"
        " 1, 2)\n"
        "assert c.tolist() == [[[20, 21, 22, 23]]], c\n"
        "assert q.tolist() == [[[12, 13, 14, 15], [16, 17, 18, 19]]], q\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, build], env=env,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    errors = [p.communicate()[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errors
    assert os.listdir(build) == [os.path.basename(core.lib_path())]


def test_threads_leave_half_the_host():
    n = core.threads()
    assert 1 <= n <= 8 and n <= max(1, (os.cpu_count() or 2) // 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_path_gathers_rows_straight_into_the_stack(s3d_dir, tmp_path,
                                                       monkeypatch, dtype):
    """The host path's call on ShapeNet3D: ``_sample_train`` draws episodes
    with their image rows not gathered (``Rows``), ``_put_train_batch``
    gathers them straight into the stack (in float32; into a float32
    array, then cast, in bfloat16) and equals ``get_batch``'s episodes
    from a freshly seeded copy, stacked, bit for bit."""
    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data

    monkeypatch.chdir(tmp_path)
    overrides = ["device=cpu", f"data_path={s3d_dir}", "device_data=false",
                 "tasks_per_batch=2", "steps_per_call=3", "gen_bg=false",
                 f"compute_dtype={dtype}"]
    yaml = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet3D.yaml")
    trainer = train_cli.build_trainer(Config(yaml, overrides,
                                             make_dirs=False))
    assert trainer.streamed
    episodes = trainer._sample_train()
    assert isinstance(episodes[0]["ctx_x"], core.Rows)
    gathers = _counting(monkeypatch)
    got = trainer._put_train_batch(episodes)
    assert len(gathers) == 2 * 3
    fresh = build_data(trainer.config)
    want = [fresh.get_batch("train", 2, trainer.config.max_ctx_num)
            for _ in range(3)]
    for k, v in got.items():
        stack = torch.from_numpy(np.stack([w[k] for w in want]))
        if k in ("ctx_x", "qry_x"):
            stack = stack.to(getattr(torch, dtype))
        assert v.dtype == stack.dtype and torch.equal(v, stack), k
