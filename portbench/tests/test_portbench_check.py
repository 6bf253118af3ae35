"""The correctness check on the CPU at a size a test holds (the cells'
own configurations and traffic, on 640x360 frames in chunks of 4):
a sound run is correct; each fault the timed path can have, planted in
the program underneath a whole run, and each cell's control, come out
not correct against the cell's committed limits."""
import pytest
import torch

from portbench import control, run
from portbench.harness import check as CK
from portbench.harness import spec
from posebyte_tpu_torch.core.structs import Detections
from posebyte_tpu_torch.pipeline import runner as R

V8, V11 = "v8n-bf16-dev720-c128", "v11n-int8-dev720-c128"
V8_1080 = "v8n-bf16-dev1080-c128"


def _run(root, cell=V8, seed=20260419, **kw):
    return run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "1", "--trace", "0"], device="cpu", root=root, **kw)


@pytest.mark.parametrize("cell", [V8, "host-tiny"])
def test_sound_run_is_correct(tiny_root, cell):
    assert _run(tiny_root, cell)["correct"]


def test_state_left_unchanged_fails(tiny_root, monkeypatch):
    real = R.tracker_chunk

    def stale(state, dets, *args, **kwargs):
        return state, real(state, dets, *args, **kwargs)[1]

    monkeypatch.setattr(R, "tracker_chunk", stale)
    assert not _run(tiny_root)["correct"]


def test_half_the_batch_left_out_fails(tiny_root, monkeypatch):
    real = R.Detector.__call__

    def half(self, frames, h, w, selection):
        det, emb = real(self, frames, h, w, selection)
        keep = torch.arange(frames.shape[0])[:, None] < frames.shape[0] // 2
        return Detections(det.poses, det.boxes,
                          torch.where(keep, det.scores, 0.0),
                          det.valid & keep), emb

    monkeypatch.setattr(R.Detector, "__call__", half)
    assert not _run(tiny_root)["correct"]


def test_answer_altered_fails(tiny_root, monkeypatch):
    real = R.pack_outputs

    def altered(outs):
        outs = dict(outs)
        outs["ids"] = outs["ids"].clone()
        outs["ids"][..., 0] += 1
        return real(outs)

    monkeypatch.setattr(R, "pack_outputs", altered)
    assert not _run(tiny_root)["correct"]


@pytest.mark.parametrize("cell", [V8, V8_1080])
def test_v8n_control_fails(tiny_root, cell):
    """The bf16 cells' control: the program's own int8 path."""
    c = spec.load_cell(cell, tiny_root)
    ctl = c.check["control"]
    assert ctl["kind"] == "program"
    res = _run(tiny_root, cell,
               program_config={**c.config, **ctl["config"]})
    assert not res["correct"]


def test_v11n_control_fails(tiny_root):
    """The w8a8 cell's control: the reference at w4a4 in the program's
    place."""
    cell = spec.load_cell(V11, tiny_root)
    ctl = cell.check["control"]
    assert ctl["kind"] == "reference"
    nums = control.reference_control(cell, 20260419, ctl["levels"],
                                     torch.device("cpu"), tiny_root)
    assert not CK.verdict(nums, cell.check["limits"])
