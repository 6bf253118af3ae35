"""The frozen scene copy draws the program's frames byte for byte."""
import numpy as np
import pytest

from portbench.reference import scene
from posebyte_tpu_torch.utils import synthetic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345])
def test_clip_equals_program_scene(seed):
    ours = scene.render_clip(3, 320, 180, 6, seed)
    sc = synthetic.SyntheticScene(6, 320, 180, seed=seed)
    theirs = np.stack([synthetic.render_frame(sc.step(), 320, 180)
                       for _ in range(3)])
    assert ours.dtype == np.uint8 and np.array_equal(ours, theirs)


def test_calibration_frames_equal_program_ones():
    assert np.array_equal(scene.calibration_frames(2, 128, 6, 11),
                          synthetic.calibration_frames(2, 128, 6, 11))
