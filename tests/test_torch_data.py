"""PyTorch port, the data layer against the JAX package's, on the CPU:
``make_synthetic_calvin``, ``DiskCalvinDataset`` (index, every sample's
arrays, padding, ``dif_ws`` windows under the same RandomState, validation
window sizes, text enrichment, data_percent, the partial-data filter, the
act_step restack), ``CalvinLoader`` (batches per epoch and shard, early
break), the native npz reader (against ``np.load`` on STORED and DEFLATE
members, its ``status()`` counts, the ``np.load`` fallback) and
``real_hdf5``.  Every comparison is exact: both packages run the same numpy
code on the same files.
"""

import json
import threading
import time

import numpy as np
import pytest

from deer_vla_tpu.data import calvin as jcalvin
from deer_vla_tpu.data import debug_data as jdebug
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu_torch.data import calvin as tcalvin
from deer_vla_tpu_torch.data import debug_data as tdebug
from deer_vla_tpu_torch.data import native_loader
from deer_vla_tpu_torch.data.text import HashTokenizer

KEYS = ("rgb_static", "rgb_gripper", "rel_actions", "robot_obs", "scene_obs")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """One split written by each package from the same seed; the port's
    second episode with savez_compressed."""
    jroot = tmp_path_factory.mktemp("jax_calvin")
    troot = tmp_path_factory.mktemp("torch_calvin")
    jdir = jdebug.make_synthetic_calvin(str(jroot), n_episodes=3, ep_len=20)
    tdir = tdebug.make_synthetic_calvin(str(troot), n_episodes=3, ep_len=20,
                                        compressed_episodes={1})
    return jdir, tdir


def assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_synthetic_calvin_matches_jax(synth):
    jdir, tdir = synth
    for i in (0, 19, 20, 39, 40, 59):
        j = np.load(f"{jdir}/episode_{i:07d}.npz")
        t = np.load(f"{tdir}/episode_{i:07d}.npz")
        assert sorted(t.files) == sorted(KEYS)
        for k in KEYS:
            np.testing.assert_array_equal(t[k], j[k])
    ja = np.load(f"{jdir}/lang_annotations/auto_lang_ann.npy",
                 allow_pickle=True).item()
    ta = np.load(f"{tdir}/lang_annotations/auto_lang_ann.npy",
                 allow_pickle=True).item()
    assert ta == ja
    # episode 1 is DEFLATE, the others STORED
    import zipfile
    kinds = {i: {m.compress_type for m in zipfile.ZipFile(
        f"{tdir}/episode_{i:07d}.npz").infolist()} for i in (0, 20, 40)}
    assert kinds == {0: {zipfile.ZIP_STORED}, 20: {zipfile.ZIP_DEFLATED},
                     40: {zipfile.ZIP_STORED}}


def write_side_files(tmp_path, jdir):
    enrich = {"rotate_blue_block_right": ["spin the blue cube clockwise",
                                          "turn the blue block right"],
              "open_drawer": ["pull the drawer open"]}
    ep = tmp_path / "enrich.json"
    ep.write_text(json.dumps(enrich))
    spans = np.load(f"{jdir}/lang_annotations/auto_lang_ann.npy",
                    allow_pickle=True).item()["info"]["indx"]
    pp = tmp_path / "partial.json"
    pp.write_text(json.dumps([list(spans[0]), list(spans[2])]))
    return str(ep), str(pp)


DATASET_CASES = {
    "default": dict(window_size=6),
    "absolute_actions": dict(window_size=6, relative_actions=False),
    "skip_frames": dict(window_size=5, skip_frames=3),
    "dif_ws": dict(window_size=8, dif_ws=True, var_min_window=5,
                   var_max_window=8),
    "text_aug": dict(window_size=6, text_aug=True),
    "data_percent": dict(window_size=6, data_percent=0.4),
    "partial_data": dict(window_size=6, partial_data=True),
    "act_step": dict(window_size=4, act_step=3),
}


@pytest.mark.parametrize("validation", [False, True])
@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_matches_jax(synth, tmp_path, case, validation):
    """len, the index and every sample, drawn in order from each package's
    own RandomState(seed), bit for bit; with act_step the collated batch."""
    jdir, tdir = synth
    enrich, partial = write_side_files(tmp_path, jdir)
    kw = dict(DATASET_CASES[case], enrich_lang_path=enrich,
              partial_task_path=partial, seed=3)
    jds = jcalvin.DiskCalvinDataset(
        jcalvin.CalvinDataConfig(dataset_dir=jdir, **kw), validation)
    tds = tcalvin.DiskCalvinDataset(
        tcalvin.CalvinDataConfig(dataset_dir=tdir, **kw), validation)
    assert len(tds) == len(jds) > 0
    np.testing.assert_array_equal(tds.episode_lookup, jds.episode_lookup)
    assert tds.lang_lookup == jds.lang_lookup
    sizes = set()
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        assert_samples_equal(got, want)
        sizes.add(int(want["actions"].shape[0]))
    cfg = tds.cfg
    assert sizes == {cfg.max_window_size}
    drawn = [tds._window_size(i) for i in range(len(tds))]
    assert drawn == [jds._window_size(i) for i in range(len(jds))]
    if case == "dif_ws":
        assert len(set(drawn)) > 1 and set(drawn) <= set(range(5, 9))
    if case == "text_aug":
        texts = [tds[i]["lang"] for i in range(len(tds))]
        assert texts == [jds[i]["lang"] for i in range(len(jds))]
        assert len(set(texts)) > 3
    tok = HashTokenizer(max_length=16)
    jtok = JaxTokenizer(max_length=16)
    idx = list(range(0, len(jds), 5))[:4]
    jb = jds.collate([jds[i] for i in idx], jtok)
    tb = tds.collate([tds[i] for i in idx], tok)
    assert_samples_equal(tb, jb)
    if case == "act_step":
        assert tb["actions"].shape == (len(idx), 4, 3, 7)


def test_padding_rules_match_jax(synth):
    """A window cut short at the episode's end: frames repeat, the arm
    dims of relative actions are zero, the gripper dim repeats
    (data.py:494-516)."""
    jdir, tdir = synth
    for relative in (True, False):
        kw = dict(window_size=6, relative_actions=relative)
        jds = jcalvin.DiskCalvinDataset(
            jcalvin.CalvinDataConfig(dataset_dir=jdir, **kw), False)
        tds = tcalvin.DiskCalvinDataset(
            tcalvin.CalvinDataConfig(dataset_dir=tdir, **kw), False)
        s = tds[0]
        short = {k: s[k][:4].copy() for k in ("rgb_static", "rgb_gripper",
                                             "actions", "robot_obs")}
        got = tds._pad_sample(dict(short), 2)
        want = jds._pad_sample({k: v.copy() for k, v in short.items()}, 2)
        assert_samples_equal(got, want)
        np.testing.assert_array_equal(got["rgb_static"][-1],
                                      got["rgb_static"][3])
        if relative:
            assert np.all(got["actions"][4:, :6] == 0)
            assert np.all(got["actions"][4:, 6] == got["actions"][3, 6])


def test_validation_window_sizes_match_jax():
    for idx in range(200):
        assert tcalvin.get_validation_window_size(idx, 5, 12) == \
            jcalvin.get_validation_window_size(idx, 5, 12)
        assert tcalvin.stable_hash(str(idx)) == jcalvin.stable_hash(str(idx))


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_loader_batches_match_jax(synth, rank, world):
    """Two epochs of shuffled, sharded batches (set_epoch reshuffles from
    RandomState(seed + epoch)), bit for bit."""
    jdir, tdir = synth
    kw = dict(window_size=6)
    jds = jcalvin.DiskCalvinDataset(
        jcalvin.CalvinDataConfig(dataset_dir=jdir, **kw), False)
    tds = tcalvin.DiskCalvinDataset(
        tcalvin.CalvinDataConfig(dataset_dir=tdir, **kw), False)
    jl = jcalvin.CalvinLoader(jds, JaxTokenizer(max_length=16), 4, rank=rank,
                              world_size=world, seed=5, workers=2)
    tl = tcalvin.CalvinLoader(tds, HashTokenizer(max_length=16), 4,
                              rank=rank, world_size=world, seed=5, workers=2)
    assert len(tl) == len(jl) == (len(jds) // world) // 4
    firsts = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl)
        for got, want in zip(tb, jb):
            assert_samples_equal(got, want)
        firsts.append(tb[0]["rgb_static"])
    assert not np.array_equal(*firsts)  # the epoch reshuffled


def test_dif_ws_loader_matches_jax(synth):
    """Variable windows through the loader (one worker: the draws come from
    the dataset's RandomState in sample order), padded to the max."""
    jdir, tdir = synth
    kw = dict(window_size=8, dif_ws=True, var_min_window=5,
              var_max_window=8)
    jl = jcalvin.CalvinLoader(jcalvin.DiskCalvinDataset(
        jcalvin.CalvinDataConfig(dataset_dir=jdir, **kw), False),
        JaxTokenizer(max_length=16), 3, seed=1, workers=1)
    tl = tcalvin.CalvinLoader(tcalvin.DiskCalvinDataset(
        tcalvin.CalvinDataConfig(dataset_dir=tdir, **kw), False),
        HashTokenizer(max_length=16), 3, seed=1, workers=1)
    for got, want in zip(list(tl), list(jl)):
        assert got["rgb_static"].shape[1] == 8
        assert_samples_equal(got, want)


def test_loader_early_break_terminates_producer(synth):
    _, tdir = synth
    ds = tcalvin.DiskCalvinDataset(
        tcalvin.CalvinDataConfig(dataset_dir=tdir, window_size=6), False)
    loader = tcalvin.CalvinLoader(ds, HashTokenizer(max_length=16),
                                  batch_size=2, prefetch=1, workers=2)
    assert len(loader) > 3
    before = threading.active_count()
    for _ in range(3):
        it = iter(loader)
        next(it)
        it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer threads leaked"


# ---------------------------------------------------------------------------
# the native reader
# ---------------------------------------------------------------------------


def frame_paths(tdir, first, n):
    return [f"{tdir}/episode_{i:07d}.npz" for i in range(first, first + n)]


@pytest.mark.parametrize("member", ["stored", "deflate"])
def test_native_reader_matches_numpy(synth, member):
    """v1 and v2 APIs against np.load; episode 0 is STORED, episode 1
    DEFLATE."""
    _, tdir = synth
    assert native_loader.available(), native_loader.status()["error"]
    paths = frame_paths(tdir, 0 if member == "stored" else 20, 6)
    frames = [np.load(p) for p in paths]
    got = native_loader.read_window_keys(paths, KEYS)
    for k in KEYS:
        want = np.stack([f[k] for f in frames])
        assert got[k].dtype == want.dtype
        np.testing.assert_array_equal(got[k], want)
        np.testing.assert_array_equal(native_loader.read_window(paths, k),
                                      want)
        np.testing.assert_array_equal(native_loader.read_key(paths[2], k),
                                      want[2])
    infos = native_loader.probe_keys(paths[0], KEYS)
    assert [(s, d) for s, d, _ in infos] == [
        (frames[0][k].shape, frames[0][k].dtype) for k in KEYS]
    assert native_loader.read_window_keys(paths, ("nope",)) is None
    assert native_loader.read_key(paths[0], "nope") is None
    assert native_loader.read_window([paths[0] + ".missing"], "robot_obs") \
        is None


def test_status_counts_the_reader_of_each_window(synth, monkeypatch):
    """Windows served natively count as native; with the library missing
    (a failed build) the dataset falls back to np.load, equal bit for bit,
    and the status says so and why."""
    _, tdir = synth
    ds = tcalvin.DiskCalvinDataset(
        tcalvin.CalvinDataConfig(dataset_dir=tdir, window_size=6), False)
    native_loader.reset_counts()
    native = [ds[i] for i in (0, 15, 30)]
    st = native_loader.status()
    assert st == {"available": True, "error": None, "native_windows": 3,
                  "numpy_windows": 0}
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", "g++ failed: test")
    fallback = [ds[i] for i in (0, 15, 30)]
    st = native_loader.status()
    assert st == {"available": False, "error": "g++ failed: test",
                  "native_windows": 3, "numpy_windows": 3}
    for got, want in zip(fallback, native):
        assert_samples_equal(got, want)
    native_loader.reset_counts()
    assert native_loader.status()["numpy_windows"] == 0


def test_native_library_builds_outside_the_jax_tree():
    assert native_loader.available()
    assert native_loader.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    assert native_loader.SRC.read_bytes() == (
        native_loader.SRC.parents[2] / "native" / "npz_reader.cpp"
    ).read_bytes()


# ---------------------------------------------------------------------------
# real_hdf5
# ---------------------------------------------------------------------------


def test_real_hdf5_helpers_match_jax():
    pytest.importorskip("h5py")
    from deer_vla_tpu.data import real_hdf5 as jreal
    from deer_vla_tpu_torch.data import real_hdf5 as treal
    r = np.random.RandomState(0)
    for _ in range(20):
        e = r.uniform(-np.pi, np.pi, 3)
        R = jreal.euler2rotm(e)
        np.testing.assert_array_equal(treal.euler2rotm(e), R)
        np.testing.assert_array_equal(treal.rotm2euler(R),
                                      jreal.rotm2euler(R))
        q = r.randn(4)
        np.testing.assert_array_equal(treal.quat2rotm(q), jreal.quat2rotm(q))
        np.testing.assert_array_equal(treal.get_mat_log(R),
                                      jreal.get_mat_log(R))
        s0, s1 = r.randn(7), r.randn(7)
        for mode in ("ee_rel_pose", "ee_rel_pose_local"):
            np.testing.assert_array_equal(
                treal.relative_ee_action(s0, s1, mode),
                jreal.relative_ee_action(s0, s1, mode))
    pos = np.cumsum(r.randn(40) * 0.02)
    cmd = (np.arange(40) // 9 % 2).astype(np.float32)
    np.testing.assert_array_equal(treal.binary_gripper_from_pos(pos, cmd),
                                  jreal.binary_gripper_from_pos(pos, cmd))
    with pytest.raises(NotImplementedError):
        treal.relative_ee_action(s0, s1, "joint")


def test_real_hdf5_windows_match_jax(tmp_path):
    pytest.importorskip("h5py")
    from deer_vla_tpu.data import real_hdf5 as jreal
    from deer_vla_tpu_torch.data import real_hdf5 as treal
    jd = jreal.make_synthetic_real_hdf5(str(tmp_path / "j"), n_frames=16)
    td = treal.make_synthetic_real_hdf5(str(tmp_path / "t"), n_frames=16)
    assert json.load(open(f"{td}/meta.json")) == \
        json.load(open(f"{jd}/meta.json"))
    jds = jreal.RealDatasetHDF5(str(tmp_path / "j"), seq_len=6)
    tds = treal.RealDatasetHDF5(str(tmp_path / "t"), seq_len=6)
    assert len(tds) == len(jds) > 0
    assert tds.seq_tuple == jds.seq_tuple
    samples = []
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        assert_samples_equal(got, want)
        samples.append((got, want))
    assert set(np.unique(samples[0][0]["actions"][:, 6])) <= {-1.0, 1.0}
    assert_samples_equal(
        tds.collate([g for g, _ in samples[:3]], HashTokenizer(max_length=8)),
        jds.collate([w for _, w in samples[:3]], JaxTokenizer(max_length=8)))
