"""The port's locked engine (models/aot.py: torch.export with the weights
baked in) on the CPU, after tests/test_quant_cli.py::test_export_cli_aot_flag:

- export_engine_aot / load_engine_aot on yolov8n at input 64: the program
  maps [B, 64, 64, 3] float32 -> [B, 56, 84] and equals eager forward_raw
  (build_model's apply_fn) within 1e-6 relative plus 1e-5 (the same
  operations; measured equal);
- int8 (w8a8): every one of the 59 quantised convs is one node of the
  operator posebyte::conv_w8a8 in the exported graph (Kernel 4 on the card,
  never its plain version traced in), and the program equals the eager
  int8 forward within the same bar;
- the export CLI's --aot flag on the CPU (the JAX test's case);
- no card and no device="cpu": export and load raise.
"""
import os

import numpy as np
import pytest
import torch

from posebyte_tpu_torch.models import init_params
from posebyte_tpu_torch.models.aot import export_engine_aot, load_engine_aot
from posebyte_tpu_torch.models.layers import prepare_params
from posebyte_tpu_torch.models.quant import quantize_params
from posebyte_tpu_torch.models.yolo_pose import build_model

torch.set_num_threads(4)

NAME = "yolov8n-pose"


@pytest.fixture(scope="module")
def params():
    return init_params(0, NAME)


def _w8a8(params):
    q = quantize_params(params)
    for k in [k for k in q if k.endswith(".scale")]:
        q[k[:-len("scale")] + "act_scale"] = np.float32(0.05)
    return q


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_export_matches_eager(params, tmp_path, precision):
    dtype = torch.float32 if precision == "fp32" else torch.bfloat16
    p = params if precision == "fp32" else _w8a8(params)
    path = str(tmp_path / "engine.pt2")
    size = export_engine_aot(p, NAME, path, batch=2, input_size=64,
                             dtype=dtype, device="cpu")
    assert size == os.path.getsize(path) > 1_000_000
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    got = load_engine_aot(path, device="cpu")(x)
    apply_fn, _ = build_model(NAME, dtype)
    with torch.inference_mode():
        want = apply_fn(prepare_params(p, dtype, "cpu"), x)
    assert got.shape == (2, 56, 84) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    nodes = [n for n in torch.export.load(path).graph.nodes
             if "posebyte.conv_w8a8" in str(n.target)]
    assert len(nodes) == (59 if precision == "int8" else 0)


def test_conv_w8a8_op_registered():
    from posebyte_tpu_torch.ops import conv_int8 as CI
    assert hasattr(torch.ops.posebyte, "conv_w8a8")
    x = torch.randn(2, 40, 9, 7).contiguous(memory_format=torch.channels_last)
    w = torch.randint(-127, 128, (24, 40, 3, 3), dtype=torch.int8)
    args = (x, torch.tensor(0.03), CI.pack_weights(w),
            torch.rand(24) * 1e-3, torch.randn(24), 3, 2)
    torch.testing.assert_close(torch.ops.posebyte.conv_w8a8(*args),
                               CI.conv_w8a8_plain(*args), rtol=0, atol=0)


def test_export_cli_aot_flag(tmp_path):
    from posebyte_tpu_torch.cli.export import main as export_main
    out, aot = str(tmp_path / "m.safetensors"), str(tmp_path / "m.pt2")
    assert export_main(["-m", NAME, "-o", out, "--no-compile", "--aot", aot,
                        "--size", "64", "--device", "cpu"]) == 0
    assert os.path.getsize(aot) > 1_000_000
    eng = load_engine_aot(aot, device="cpu")
    assert eng(torch.zeros((1, 64, 64, 3))).shape == (1, 56, 84)


def test_no_card_raises(params, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_engine_aot(params, NAME, str(tmp_path / "e.pt2"),
                          input_size=64)
    path = str(tmp_path / "cpu.pt2")
    export_engine_aot(params, NAME, path, input_size=64, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_engine_aot(path)
    from posebyte_tpu_torch.cli.export import main as export_main
    with pytest.raises(SystemExit, match="no CUDA device"):
        export_main(["-m", NAME, "-o", str(tmp_path / "m.safetensors"),
                     "--aot", str(tmp_path / "m.pt2")])
