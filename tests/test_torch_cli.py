"""The port's command line (posebyte_tpu_torch/cli/) against the JAX
package's on the CPU: the demo on one mp4 written here with cv2 from
JAX-rendered frames of the crowded scene (posebyte_tpu.utils.synthetic),
yolov8n-pose at 256 from assets/, fp32, -v: the per-frame ids equal to
posebyte_tpu.cli.demo's, the chunked ids (--chunk 8) equal to the
per-frame ones, and a --save-state file of either package resumed by the
other with the same ids; the benchmark's JSON keys; a bare model name on
random weights in every CLI; the refusal without a card and without
--device cpu; and the flag values the port once refused (--topk-impl
bisect and approx, export --aot), run.

The JAX package's load_params builds its tree with init_params, whose
random initialisation is replaced here by jax.eval_shape (every leaf is
overwritten from the file), 20 s saved per load.
"""
import ast
import json
import os

import jax
import numpy as np
import pytest
import torch

from posebyte_tpu.models import weights as JW
from posebyte_tpu.models.yolo_pose import init_params
from posebyte_tpu.utils import synthetic as JS
from posebyte_tpu.utils.video import VideoWriter

from posebyte_tpu_torch.cli import benchmark, demo, evaluate, export
from posebyte_tpu_torch.utils.checkpoint import load_tracker_state

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "assets", "yolov8n-pose-synthetic256.safetensors")
W, H, N_FRAMES = 640, 360, 24
BASE = ["-e", ASSET, "--size", "256", "--precision", "fp32", "-v"]


@pytest.fixture(autouse=True)
def jax_tree_by_shape(monkeypatch):
    monkeypatch.setattr(JW, "init_params", lambda key, name: jax.eval_shape(
        lambda k: init_params(k, name), key))


def write_crowd_clip(path: str) -> np.ndarray:
    """24 frames of the crowded scene (6 people crossing, entering and
    leaving), rendered by the JAX package's cv2 renderer, as an mp4 at
    `path`; returns the people's poses [24, 6, 17, 3], those not in the
    frame with confidence 0."""
    scene = JS.CrowdedScene(n_persons=6, width=W, height=H, seed=86002,
                            scale_range=(80.0, 130.0), speed=5.0,
                            clip_len=N_FRAMES)
    writer = VideoWriter(path, W, H, 30.0)
    gt = []
    for poses, active in scene.frames(N_FRAMES):
        writer.write(JS.render_frame(poses[active], W, H))
        poses[~active, :, 2] = 0.0
        gt.append(poses)
    writer.release()
    return np.stack(gt)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "crowd.mp4")
    write_crowd_clip(path)
    return path


def _ids(out: str) -> list:
    """The per-frame ids a -v run printed."""
    return [ast.literal_eval(line.split("ids=")[1])
            for line in out.splitlines()
            if line.startswith("frame ") and "ids=" in line]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_demo_ids_match_jax_chunked_and_across_resumes(clip, tmp_path,
                                                       capsys):
    from posebyte_tpu.cli import demo as jdemo
    p_state, j_state = str(tmp_path / "p.st"), str(tmp_path / "j.st")
    p_state2, drawn = str(tmp_path / "p2.st"), str(tmp_path / "out.mp4")
    args = BASE + ["-i", clip, "--device", "cpu"]

    out = _run(demo.main, args + ["--save-state", p_state, "-o", drawn],
               capsys)
    ids = _ids(out)
    assert len(ids) == N_FRAMES and max(map(len, ids)) >= 4
    assert "Frames processed: 24" in out and "Mean dispatch:" in out
    assert os.path.getsize(drawn) > 0
    assert _ids(_run(jdemo.main, BASE + ["-i", clip], capsys)) == ids

    chunked = _run(demo.main, args + ["--chunk", "8", "--timing"], capsys)
    assert _ids(chunked) == ids
    assert "Timing breakdown (10 frames)" in chunked

    # a state saved by the port, resumed by both packages
    j_ids = _ids(_run(jdemo.main, BASE + ["-i", clip, "--resume-state",
                                          p_state, "--save-state", j_state],
                      capsys))
    resumed = _run(demo.main, args + ["--resume-state", p_state,
                                      "--save-state", p_state2], capsys)
    assert "(frame 24, next id" in resumed
    assert _ids(resumed) == j_ids and j_ids != ids
    mine, theirs = load_tracker_state(p_state2), load_tracker_state(j_state)
    for f in ("ids", "states", "hits", "ages", "active", "next_id", "frame",
              "det_track_slot"):
        assert torch.equal(getattr(mine, f), getattr(theirs, f)), f
    torch.testing.assert_close(mine.poses, theirs.poses, rtol=1e-6,
                               atol=1e-4)
    # and the JAX package's state resumed by the port
    again = _run(demo.main, args + ["--resume-state", j_state], capsys)
    assert f"(frame 48, next id {int(theirs.next_id)})" in again
    assert len(_ids(again)) == N_FRAMES


def test_benchmark_json_keys_match_jax(capsys):
    from posebyte_tpu.cli import benchmark as jbench
    out = _run(benchmark.main, ["-n", "2", "--json", "--device", "cpu",
                                "--stages"], capsys)
    assert "Tracker Timing Stats (2 frames)" in out
    got = json.loads(out.strip().splitlines()[-1])
    want = json.loads(_run(jbench.main, ["-n", "2", "--json"],
                           capsys).strip().splitlines()[-1])
    assert list(got) == list(want)
    assert all(v > 0 for v in got.values())


def test_benchmark_end_to_end_and_fixture():
    """-e adds e2e_<model>_ms through PosePipeline; the fixture is the JAX
    package's pose generator, draw for draw."""
    from posebyte_tpu.cli.benchmark import generate_random_pose as jgen
    a, b = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(3):
        np.testing.assert_array_equal(benchmark.generate_random_pose(a),
                                      jgen(b))
    res = benchmark.run(1, torch.device("cpu"), engine=ASSET)
    assert res["e2e_yolov8n-pose_ms"] > 0


CLIS = {"demo": (demo.main, ["-e", ASSET, "-i", "x.mp4"]),
        "evaluate": (evaluate.main, ["-e", ASSET, "-i", "x.mp4", "-g",
                                     "gt.npz"]),
        "export": (export.main, ["-m", ASSET, "-o", "x.safetensors"]),
        "benchmark": (benchmark.main, ["-n", "1"])}


@pytest.mark.parametrize("cli", list(CLIS))
def test_no_card_and_no_device_cpu_fails(cli):
    """Without a card each CLI fails through resolve_device, before it
    reads anything, rather than run on the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    main, argv = CLIS[cli]
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("cli,argv", [
    ("demo", ["--topk-impl", "bisect"]),
    ("demo", ["--topk-impl", "approx"]),
    ("export", ["--aot", "e.pt2"]),
], ids=["bisect", "approx", "aot"])
def test_unsupported_flags_name_their_roadmap_item(cli, argv, clip, tmp_path,
                                                   monkeypatch, capsys):
    """The flag values the port once refused, naming their ROADMAP items,
    now run on the CPU: the demo's --topk-impl bisect and approx give the
    per-frame ids of the default ranking (sort) on the clip, and export's
    --aot writes a locked engine that models.aot loads."""
    monkeypatch.chdir(tmp_path)
    if cli == "demo":
        args = BASE + ["-i", clip, "--device", "cpu"]
        ids = _ids(_run(demo.main, args + argv, capsys))
        assert len(ids) == N_FRAMES and max(map(len, ids)) >= 4
        assert ids == _ids(_run(demo.main, args, capsys))
        return
    from posebyte_tpu_torch.models.aot import load_engine_aot
    out = _run(export.main, ["-m", ASSET, "-o", "x.safetensors", "--size",
                             "64", "--no-compile", "--device", "cpu"] + argv,
               capsys)
    assert "AOT engine -> e.pt2" in out
    assert load_engine_aot("e.pt2", device="cpu")(
        torch.zeros((1, 64, 64, 3))).shape == (1, 56, 84)


@pytest.mark.parametrize("cli", list(CLIS))
def test_bare_model_name_runs_random_weights(cli, clip, tmp_path,
                                             monkeypatch, capsys):
    """A bare model name runs on random weights (init_params, seed 0), as
    in the JAX package, whose load_model_params returns no params for it
    and whose CLIs then initialise the model: the same key tree."""
    from posebyte_tpu.cli.demo import load_model_params as jload
    from posebyte_tpu_torch.models.weights import load_params, \
        params_from_jax
    monkeypatch.chdir(tmp_path)
    name = "yolo11n-pose" if cli == "evaluate" else "yolov8n-pose"
    params, got = demo.load_model_params(name)
    assert (None, name) == jload(name) and got == name
    tree = jax.eval_shape(lambda k: init_params(k, name),
                          jax.random.PRNGKey(0))
    assert sorted(params) == sorted(params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), tree)))
    small = ["--size", "64", "--precision", "fp32", "--device", "cpu"]
    if cli == "demo":
        out = _run(demo.main, ["-e", name, "-i", clip] + small, capsys)
        assert f"Frames processed: {N_FRAMES}" in out
    elif cli == "evaluate":
        np.savez("gt.npz", poses=np.zeros((N_FRAMES, 1, 17, 3), np.float32))
        _run(evaluate.main, ["-e", name, "-i", clip, "-g", "gt.npz",
                             "--json", "--size", "64", "--device", "cpu"],
             capsys)
    elif cli == "export":
        _run(export.main, ["-m", name, "-o", "x.safetensors", "-p", "fp32",
                           "--device", "cpu"], capsys)
        saved, meta_name = load_params("x.safetensors")
        assert meta_name == name
        for k, v in params.items():
            np.testing.assert_array_equal(saved[k], v)
    else:
        out = _run(benchmark.main, ["-n", "1", "-e", name, "--json",
                                    "--device", "cpu"], capsys)
        assert json.loads(out.strip().splitlines()[-1])[
            f"e2e_{name}_ms"] > 0


def test_profiling_records_match_jax(capsys):
    """FrameTiming and TrackerTiming: the JAX package's fields, report and
    printed table on the same numbers."""
    import dataclasses
    from posebyte_tpu.utils import profiling as JP
    from posebyte_tpu_torch.utils import profiling as P
    for ours, theirs in ((P.FrameTiming, JP.FrameTiming),
                         (P.TrackerTiming, JP.TrackerTiming)):
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(theirs)]
    vals = dict(preprocess_ms=3.0, detect_ms=50.0, track_ms=7.5,
                total_ms=70.0, frames=10)
    assert P.FrameTiming(**vals).report() == JP.FrameTiming(**vals).report()
    vals = {f.name: float(i + 1) for i, f in enumerate(
        dataclasses.fields(P.TrackerTiming))}
    vals["frame_count"] = 4
    P.TrackerTiming(**vals).print_stats()
    ours = capsys.readouterr().out
    JP.TrackerTiming(**vals).print_stats()
    assert ours == capsys.readouterr().out
