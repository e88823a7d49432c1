"""chd_tpu_torch's external drivers, dataset layout helper and host commands
against chd_tpu's, on the same inputs. All host code, compared exactly:

- ``pad_image`` and ``resize_image``: equal images on the shapes of
  tests/test_external.py;
- ``extract_frames``: equal PNG frames from one small mp4;
- ``run_openpose`` (every ``hands``/``face``/``save_video`` combination)
  and ``run_totalcap``, with ``subprocess.run`` recorded: the same commands,
  working directories and ``check`` flags, and the same files collected
  into each video dir; through the CLI, the same calls as chd_tpu's CLI;
- without their binaries both CLI commands raise ``FileNotFoundError``, as
  chd_tpu's do (tests/test_cli.py);
- ``make-structure``: the same tree of video dirs and the same printed
  lines (relative to each output dir); ``config``: the same bytes.
"""
import os
import subprocess

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from chd_tpu.pipeline import cli as jax_cli
from chd_tpu.pipeline import external as jax_external
from chd_tpu_torch.pipeline import cli, external

PACKAGES = {"chd_tpu": (jax_external, jax_cli), "chd_tpu_torch": (external, cli)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's other test files pin it."""
    torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(720, 1280, 3), (1080, 1920, 3), (480, 640, 3)])
def test_pad_image_matches_chd_tpu(shape):
    im = np.random.default_rng(0).integers(0, 255, size=shape, dtype=np.uint8)
    got = external.pad_image(im.copy(), (1920, 1080))
    np.testing.assert_array_equal(got, jax_external.pad_image(im.copy(), (1920, 1080)))
    assert got.shape == (max(shape[0], 1080), max(shape[1], 1920), 3)


@pytest.mark.parametrize("shape", [(720, 1280, 3), (1080, 1440, 3), (2160, 3840, 3)])
def test_resize_image_matches_chd_tpu(shape):
    im = np.random.default_rng(1).integers(0, 255, size=shape, dtype=np.uint8)
    got = external.resize_image(im.copy(), (1920, 1080))
    np.testing.assert_array_equal(got, jax_external.resize_image(im.copy(), (1920, 1080)))


def _write_mp4(path, frames=3, size=(96, 64)):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, size)
    if not writer.isOpened():
        pytest.skip("cv2 opens no mp4 writer on this machine")
    rng = np.random.default_rng(2)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, size=(size[1], size[0], 3), dtype=np.uint8))
    writer.release()


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_extract_frames_matches_chd_tpu(tmp_path):
    video = str(tmp_path / "clip.mp4")
    _write_mp4(video)
    n = {name: mod.extract_frames(video, str(tmp_path / name), target=(128, 72))
         for name, (mod, _) in PACKAGES.items()}
    assert n == {"chd_tpu": 3, "chd_tpu_torch": 3}
    got, want = _tree(str(tmp_path / "chd_tpu_torch")), _tree(str(tmp_path / "chd_tpu"))
    assert sorted(got) == ["00000001.png", "00000002.png", "00000003.png"]
    assert got == want


@pytest.fixture()
def recorded_runs(monkeypatch):
    """subprocess.run replaced by a recorder; a run of the MTC script writes
    the outputs that run_totalcap collects."""
    calls = []

    def run(cmd, cwd=None, check=False):
        calls.append((list(cmd), cwd, check))
        if cmd[0] == "bash":
            out = os.path.join(cwd, "data", cmd[2])
            os.makedirs(os.path.join(out, "openpose_result"), exist_ok=True)
            with open(os.path.join(out, "tracked_results.json"), "w") as f:
                f.write('{"totalcapResults": []}')
            with open(os.path.join(out, "openpose_result", "a_keypoints.json"), "w") as f:
                f.write('{"people": []}')
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", run)
    return calls


def _data_dir(root):
    for name in ("vidA", "vidB"):
        os.makedirs(os.path.join(root, "data", name))
    os.makedirs(os.path.join(root, "data", ".hidden"))
    return [os.path.join(root, "data", n) for n in ("vidA", "vidB")]


@pytest.mark.parametrize("hands", [False, True])
@pytest.mark.parametrize("face", [False, True])
@pytest.mark.parametrize("save_video", [False, True])
def test_run_openpose_commands_match_chd_tpu(tmp_path, recorded_runs, hands, face, save_video):
    root = str(tmp_path / "openpose")
    os.makedirs(os.path.join(root, "build", "examples", "openpose"))
    open(os.path.join(root, "build", "examples", "openpose", "openpose.bin"), "w").close()
    dirs = _data_dir(str(tmp_path))
    runs = {}
    for name, (mod, _) in PACKAGES.items():
        recorded_runs.clear()
        mod.run_openpose(dirs, root, hands=hands, face=face, save_video=save_video)
        runs[name] = list(recorded_runs)
    assert runs["chd_tpu_torch"] == runs["chd_tpu"]
    assert len(runs["chd_tpu"]) == 2 and all(cwd == root and check for _, cwd, check in
                                             runs["chd_tpu"])
    assert ("--hand" in runs["chd_tpu"][0][0]) == hands
    assert all(os.path.isdir(os.path.join(d, "openpose_result")) for d in dirs)
    flags = [f for f, on in (("--hands", hands), ("--face", face), ("--save-video", save_video))
             if on]
    for name, (_, mod_cli) in PACKAGES.items():
        recorded_runs.clear()
        assert mod_cli.main(["openpose", "--data", str(tmp_path / "data"), "--openpose", root,
                             *flags]) == 0
        assert recorded_runs == runs["chd_tpu"], name


def test_run_totalcap_commands_and_files_match_chd_tpu(tmp_path, recorded_runs):
    mtc = str(tmp_path / "mtc")
    os.makedirs(mtc)
    open(os.path.join(mtc, "run_pipeline_no_ffmpeg.sh"), "w").close()
    dirs = _data_dir(str(tmp_path))
    _write_mp4(os.path.join(dirs[0], "vidA.mp4"))
    runs, trees = {}, {}
    for name, (mod, mod_cli) in PACKAGES.items():
        recorded_runs.clear()
        mod.run_totalcap(dirs, mtc)
        runs[name] = list(recorded_runs)
        trees[name] = {d: _tree(d) for d in dirs}
        recorded_runs.clear()
        assert mod_cli.main(["totalcap", "--data", str(tmp_path / "data"), "--totalcap",
                             mtc]) == 0
        assert recorded_runs == runs[name]
    assert runs["chd_tpu_torch"] == runs["chd_tpu"] == [
        (["bash", os.path.join(mtc, "run_pipeline_no_ffmpeg.sh"), n], mtc, True)
        for n in ("vidA", "vidB")]
    assert trees["chd_tpu_torch"] == trees["chd_tpu"]
    got = trees["chd_tpu_torch"][dirs[0]]
    assert "tracked_results.json" in got and "raw_image/00000003.png" in got
    assert os.path.join("openpose_result", "a_keypoints.json") in got


@pytest.mark.parametrize("cmd,flag", [("openpose", "--openpose"), ("totalcap", "--totalcap")])
def test_external_cmds_require_binary(tmp_path, cmd, flag):
    os.makedirs(tmp_path / "data" / "vid1")
    for _, mod_cli in PACKAGES.values():
        with pytest.raises(FileNotFoundError, match="not found at"):
            mod_cli.main([cmd, "--data", str(tmp_path / "data"), flag, str(tmp_path)])


def test_make_structure_matches_chd_tpu(tmp_path, capsys):
    src = tmp_path / "videos"
    src.mkdir()
    for name, payload in (("b_clip.mp4", b"\x00\x01"), ("a_clip.mp4", b"mp4"),
                          ("notes.txt", b"x"), ("c.MP4", b"upper")):
        (src / name).write_bytes(payload)
    printed = {}
    for name, (_, mod_cli) in PACKAGES.items():
        out = str(tmp_path / name)
        assert mod_cli.main(["make-structure", "--data", str(src), "--out", out]) == 0
        printed[name] = [os.path.relpath(line, out)
                         for line in capsys.readouterr().out.splitlines()]
    assert printed["chd_tpu_torch"] == printed["chd_tpu"] == ["a_clip", "b_clip"]
    got, want = _tree(str(tmp_path / "chd_tpu_torch")), _tree(str(tmp_path / "chd_tpu"))
    assert got == want == {os.path.join("a_clip", "a_clip.mp4"): b"mp4",
                           os.path.join("b_clip", "b_clip.mp4"): b"\x00\x01"}
    assert sorted(os.listdir(src)) == ["a_clip.mp4", "b_clip.mp4", "c.MP4", "notes.txt"]
    for _, (_, mod_cli) in PACKAGES.items():
        with pytest.raises(FileNotFoundError):
            mod_cli.main(["make-structure", "--data", str(tmp_path / "none"), "--out",
                          str(tmp_path / "o")])


def test_config_prints_the_same_bytes(capfd):
    printed = {}
    for name, (_, mod_cli) in PACKAGES.items():
        assert mod_cli.main(["config"]) == 0
        printed[name] = capfd.readouterr().out
    assert printed["chd_tpu_torch"] == printed["chd_tpu"]
    assert '"kinematic"' in printed["chd_tpu"] and '"physics"' in printed["chd_tpu"]
