"""chd_tpu_torch.viz against chd_tpu.viz on the same seeded inputs.

Rendering is host code in both packages (numpy, matplotlib's Agg, cv2), so
every comparison is bitwise:
- each animation's frames, captured at ``VideoSink.write`` (3 frames, small
  figures), equal chd_tpu's; the port's frames from CPU tensors equal its
  frames from numpy;
- each plot's decoded PNG pixels equal chd_tpu's, and the port's from
  tensors equal its own from numpy; ``plot_train_curves`` also draws the
  history that the port's ``contact.train.train`` returns;
- ``blender``: ``estimate_kinematic_forces`` and ``pick_result`` equal
  chd_tpu's; under the fake ``bpy``/``mathutils`` of
  tests/test_blender_stub.py, ``render_multiview_eval`` records the same
  renders and the same keyframed values in both packages;
- every viz module (and the host modules of the pipeline) imports on a
  machine without matplotlib and cv2.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

import chd_tpu.viz.blender as jax_blender
from chd_tpu import viz as jax_viz
from chd_tpu.characters import defs as jax_defs
from chd_tpu.physics import towr_io as jax_towr_io
from chd_tpu.viz import video as jax_video
import chd_tpu_torch.viz.blender as blender
from chd_tpu_torch import viz
from chd_tpu_torch.characters import defs
from chd_tpu_torch.contact import synth
from chd_tpu_torch.contact import train as train_lib
from chd_tpu_torch.physics import towr_io
from chd_tpu_torch.viz import plots, video
from test_blender_stub import FakeObj, Vector, _fake_video_dir, make_fake_bpy

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's other test files pin it."""
    torch.set_num_threads(1)


@pytest.fixture()
def frames(monkeypatch):
    """The frames each package's VideoSink is given, by package; they are
    still written."""
    got = {"chd_tpu": [], "chd_tpu_torch": []}
    for name, mod in (("chd_tpu", jax_video), ("chd_tpu_torch", video)):
        def write(self, frame, _orig=mod.VideoSink.write, _name=name):
            got[_name].append(np.array(frame, copy=True))
            _orig(self, frame)

        monkeypatch.setattr(mod.VideoSink, "write", write)
    return got


def _written(path):
    return os.path.exists(path) or os.path.isdir(path + ".frames")


def _render_three_ways(frames, jax_fn, fn, numpy_args, tensor_args, out_dir):
    """chd_tpu's frames from numpy, the port's from numpy and from tensors:
    returns the three lists of frames."""
    runs = []
    for k, (render, args) in enumerate(((jax_fn, numpy_args), (fn, numpy_args),
                                        (fn, tensor_args))):
        key = "chd_tpu" if k == 0 else "chd_tpu_torch"
        before = len(frames[key])
        out = os.path.join(out_dir, f"run{k}.mp4")
        assert render(out_path=out, **args) == out and _written(out)
        runs.append(frames[key][before:])
    return runs


def test_to_host_moves_every_tensor():
    res = towr_io.LoadedResults(4, 1 / 30, *(torch.ones(2, 3) for _ in range(6)))
    tree = {"a": [torch.zeros(2), (torch.ones(1, dtype=torch.float64), 3)], "r": res, "s": "x"}
    got = video.to_host(tree)
    assert isinstance(got["a"][0], np.ndarray) and isinstance(got["a"][1], tuple)
    assert got["a"][1][0].dtype == np.float64 and got["a"][1][1] == 3 and got["s"] == "x"
    assert isinstance(got["r"], towr_io.LoadedResults) and got["r"].num_feet == 4
    assert all(isinstance(getattr(got["r"], f), np.ndarray) for f in res._fields[2:])


def test_animate_skeletons_matches_chd_tpu(tmp_path, frames):
    rng = np.random.default_rng(0)
    pts = [rng.normal(size=(4, 28, 3)) * 50, rng.normal(size=(3, 28, 3)) * 40 + 20]
    contacts = (rng.uniform(size=(4, 28)) > 0.8).astype(np.int64)
    normal, point = np.array([0.01, -1.0, 0.0]), np.array([0.0, 90.0, 0.0])
    common = dict(adjacency=[jax_defs.COMBINED_ADJ_LIST] * 2, figsize=(4, 3), max_frames=3)
    numpy_args = dict(joints3d=pts, contacts=contacts, floor_normal=normal, floor_point=point,
                      **common)
    tensor_args = dict(joints3d=[torch.from_numpy(p) for p in pts],
                       contacts=torch.from_numpy(contacts), floor_normal=torch.from_numpy(normal),
                       floor_point=torch.from_numpy(point), **common)
    want, got, from_tensors = _render_three_ways(
        frames, jax_viz.animate_skeletons, viz.animate_skeletons, numpy_args, tensor_args,
        str(tmp_path))
    assert len(want) == 3 and want[0].shape == (300, 400, 3)
    for w, g, t in zip(want, got, from_tensors):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(t, g)
    assert not np.array_equal(want[0], want[2])
    from chd_tpu.viz.skeleton3d import eval_plane as jax_eval_plane
    from chd_tpu_torch.viz.skeleton3d import eval_plane

    for xz in ((3.0, -2.0), (0.0, 0.0)):
        assert eval_plane(torch.from_numpy(normal), torch.from_numpy(point), xz) == \
            jax_eval_plane(normal, point, xz)


@pytest.mark.parametrize("background", [False, True])
def test_render_keypoint_video_matches_chd_tpu(tmp_path, frames, background):
    rng = np.random.default_rng(1)
    kp = [np.concatenate([rng.uniform(10, 300, size=(4, 25, 2)),
                          rng.uniform(0, 1, size=(4, 25, 1))], axis=-1),
          rng.uniform(10, 170, size=(3, 25, 2))]
    contacts = (rng.uniform(size=(4, 4)) > 0.5).astype(np.int64)
    common = dict(dimensions=(320, 180))
    if background:
        path = str(tmp_path / "background.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (320, 180))
        assert writer.isOpened()
        for _ in range(2):  # fewer frames than keypoints: the last is black
            writer.write(rng.integers(0, 255, size=(180, 320, 3), dtype=np.uint8))
        writer.release()
        common["video_path"] = path
    want, got, from_tensors = _render_three_ways(
        frames, jax_viz.render_keypoint_video, viz.render_keypoint_video,
        dict(joint2d_list=kp, contacts=contacts, **common),
        dict(joint2d_list=[torch.from_numpy(k) for k in kp],
             contacts=torch.from_numpy(contacts), **common), str(tmp_path))
    assert len(want) == 3 and want[0].shape == (180, 320, 3)
    for w, g, t in zip(want, got, from_tensors):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(t, g)
    assert defs.BODY_25_ADJ_LIST.shape == (24, 2)


def test_animate_physics_results_matches_chd_tpu(tmp_path, frames):
    rng = np.random.default_rng(2)
    F = 4
    fields = dict(base_pos=rng.normal(size=(F, 3)), base_rot=np.zeros((F, 3)),
                  base_R=np.tile(np.eye(3), (F, 1, 1)), feet_pos=rng.normal(size=(F, 4, 3)),
                  feet_force=rng.normal(size=(F, 4, 3)) * 200,
                  feet_contact=(rng.uniform(size=(F, 4)) > 0.5).astype(np.int64))
    jax_res = jax_towr_io.LoadedResults(num_feet=4, dt=1 / 30, **fields)
    res = towr_io.LoadedResults(num_feet=4, dt=1 / 30, **fields)
    res_t = towr_io.LoadedResults(num_feet=4, dt=1 / 30,
                                  **{k: torch.from_numpy(v) for k, v in fields.items()})
    skel = rng.normal(size=(F, 5, 3))
    parents = [-1, 0, 1, 0, 3]
    common = dict(names=["Dyn", "Init"], skeleton_parents=[parents, parents], max_frames=3)
    floor = dict(floor_normal=np.array([0.0, -1.0, 0.01]), floor_point=np.array([0.0, 1.0, 0.0]))
    want, got, from_tensors = _render_three_ways(
        frames,
        lambda results, **kw: jax_viz.animate_physics_results([jax_res, jax_res], **common, **kw),
        lambda results, **kw: viz.animate_physics_results(results, **common, **kw),
        dict(results=[res, res], skeleton_positions=[skel, skel + 0.5], **floor),
        dict(results=[res_t, res_t],
             skeleton_positions=[torch.from_numpy(skel), torch.from_numpy(skel + 0.5)],
             **{k: torch.from_numpy(v) for k, v in floor.items()}),
        str(tmp_path))
    assert len(want) == 3 and want[0].shape == (600, 900, 3)
    for w, g, t in zip(want, got, from_tensors):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(t, g)
    np.testing.assert_array_equal(res_t.base_pos.numpy(), fields["base_pos"])  # not flipped


def _pixels(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert img is not None and img.size > 0, path
    return img


@pytest.fixture(scope="module")
def history():
    """The history of two epochs of the port's training, on the CPU."""
    ds = synth.learnable_dataset(n_seq=12, frames=30, device="cpu")
    cfg = train_lib.TrainConfig(epochs=2, batch_size=8, val_every=1)
    _, hist = train_lib.train(ds, cfg, log_every=1, verbose=False)
    assert len(hist["train_loss"]) == 2 and len(hist["val_f1"]) == 2
    return hist


@pytest.mark.parametrize("plot", ["train_curves", "train_history", "confusion_matrix",
                                  "accuracy_hist", "3curve"])
def test_plots_match_chd_tpu(tmp_path, plot, history):
    rng = np.random.default_rng(3)
    f64 = dict(dtype=torch.float64)
    kw = {}
    if plot == "train_curves":
        hist = {"train_loss": [1.0, 0.8, 0.6], "val_loss": [0.9, 0.7],
                "train_acc": [0.5, 0.6, 0.7], "val_f1": [0.4, 0.55]}
        args = (hist,)
        targs = ({"train_loss": torch.tensor(hist["train_loss"], **f64),
                  "val_loss": [torch.tensor(v, **f64) for v in hist["val_loss"]],
                  "train_acc": torch.tensor(hist["train_acc"], **f64),
                  "val_f1": hist["val_f1"]},)
    elif plot == "train_history":
        plot, args = "train_curves", (history,)
        targs = ({k: torch.tensor(v, **f64) if k != "val_metrics" else v
                  for k, v in history.items()},)
    elif plot == "confusion_matrix":
        args, targs = ((10, 2, 3, 40),), (torch.tensor([10, 2, 3, 40]),)
    elif plot == "accuracy_hist":
        acc = list(rng.uniform(0.8, 1.0, size=5))
        args, targs = (acc,), (torch.tensor(acc, **f64),)
    else:
        arr = rng.normal(size=(10, 3))
        args, targs = (arr, 1 / 30), (torch.from_numpy(arr), torch.tensor(1 / 30, **f64))
        kw = dict(ylabel="pos")
    paths = [str(tmp_path / f"{k}.png") for k in range(3)]
    for fn, a, path in ((getattr(jax_viz.plots, f"plot_{plot}"), args, paths[0]),
                        (getattr(plots, f"plot_{plot}"), args, paths[1]),
                        (getattr(plots, f"plot_{plot}"), targs, paths[2])):
        assert fn(*a, out_path=path, **kw) == path
    want, got, from_tensors = (_pixels(p) for p in paths)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(from_tensors, got)


def test_viz_exports_match_chd_tpu():
    assert sorted(n for n in dir(viz) if not n.startswith("_")) == \
        sorted(n for n in dir(jax_viz) if not n.startswith("_"))


def test_estimate_kinematic_forces_and_pick_result_match_chd_tpu(tmp_path):
    rng = np.random.default_rng(4)
    com = np.cumsum(rng.normal(0, 0.01, size=(12, 3)), axis=0) + [0.0, 1.0, 0.0]
    normal = np.array([0.02, 1.0, -0.01])
    for F in (12, 2):
        want = jax_blender.estimate_kinematic_forces(com[:F], normal, 61.3, 30.0)
        got = blender.estimate_kinematic_forces(com[:F], normal, 61.3, 30.0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            blender.estimate_kinematic_forces(torch.from_numpy(com[:F]),
                                              torch.from_numpy(normal), 61.3, 30.0), got)
        assert got.shape == (F, 1, 3)
    log = str(tmp_path / "success_log.txt")
    assert blender.pick_result(str(tmp_path)) == jax_blender.pick_result(str(tmp_path)) == \
        "no_dynamics"
    for dyn, dur, label in ((True, False, "dynamics"), (True, True, "durations"),
                            (False, True, "durations"), (False, False, "no_dynamics")):
        towr_io.save_success_log(log, dyn, dur)
        assert blender.pick_result(str(tmp_path)) == jax_blender.pick_result(str(tmp_path)) \
            == label
    assert blender.CHARACTER_SCALE == jax_blender.CHARACTER_SCALE


@pytest.fixture()
def fake_blender(monkeypatch):
    """Both packages' blender modules reloaded inside a fake Blender, each
    with its own fake ``bpy``; every keyframe records its object's type, the
    keyframed value and the frame. Yields ({package: (module, bpy)},
    {package: keyframes})."""
    keyframes = {}
    current = []

    def plain(v):
        if isinstance(v, Vector):
            return tuple(float(x) for x in v.v)
        if isinstance(v, tuple):
            return tuple(float(x) for x in v)
        return type(v).__name__

    def keyframe_insert(self, data_path, frame):
        keyframes[current[0]].append((self.type, data_path, frame,
                                      plain(getattr(self, data_path))))

    monkeypatch.setattr(FakeObj, "keyframe_insert", keyframe_insert)
    mathutils = type(sys)("mathutils")
    mathutils.Vector = Vector
    monkeypatch.setitem(sys.modules, "mathutils", mathutils)
    mods = {}
    for name, mod in (("chd_tpu", jax_blender), ("chd_tpu_torch", blender)):
        fake_bpy = make_fake_bpy()
        monkeypatch.setitem(sys.modules, "bpy", fake_bpy)
        mods[name] = (importlib.reload(mod), fake_bpy)
        keyframes[name] = []
    yield mods, keyframes, current
    monkeypatch.delitem(sys.modules, "bpy")
    monkeypatch.delitem(sys.modules, "mathutils")
    importlib.reload(jax_blender)
    importlib.reload(blender)


@pytest.mark.parametrize("kinematic_result", [False, True])
def test_render_multiview_eval_matches_chd_tpu(tmp_path, fake_blender, kinematic_result):
    mods, keyframes, current = fake_blender
    vd = _fake_video_dir(tmp_path, F=5)
    out = str(tmp_path / "render_out")
    for name, (mod, fake_bpy) in mods.items():
        assert mod.HAVE_BPY
        current[:] = [name]
        mod.render_multiview_eval(vd, "ybot", fbx_path="char.fbx", out_dir=out, num_views=2,
                                  kinematic_result=kinematic_result)
    renders = {name: fake_bpy._state["renders"] for name, (_, fake_bpy) in mods.items()}
    assert renders["chd_tpu_torch"] == renders["chd_tpu"]
    assert len(renders["chd_tpu"]) == (4 if kinematic_result else 2)
    assert keyframes["chd_tpu_torch"] == keyframes["chd_tpu"]
    # per pass: the COM sphere's 5 locations, 4 arrows x 5 frames x 3 paths
    # (1 arrow for the kinematic-only pass's single estimated force)
    assert len(keyframes["chd_tpu"]) == 5 + 60 + (5 + 15 if kinematic_result else 0)


def test_host_modules_import_without_matplotlib_or_cv2():
    modules = ["chd_tpu_torch.viz", "chd_tpu_torch.viz.video", "chd_tpu_torch.viz.skeleton3d",
               "chd_tpu_torch.viz.keypoints2d", "chd_tpu_torch.viz.physics_viz",
               "chd_tpu_torch.viz.plots", "chd_tpu_torch.viz.blender",
               "chd_tpu_torch.pipeline.external", "chd_tpu_torch.pipeline.structure",
               "chd_tpu_torch.utils.profiling"]
    code = ("import sys\nsys.modules['matplotlib'] = sys.modules['cv2'] = None\n"
            f"import {', '.join(modules)}\n"
            "from chd_tpu_torch.viz import plots\n"
            "try:\n    plots.plot_3curve([[0.0] * 3], 0.1, 'x.png')\n"
            "except ImportError:\n    print('no matplotlib')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "no matplotlib", out.stderr
