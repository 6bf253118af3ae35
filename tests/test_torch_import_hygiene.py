"""Importing posebyte_tpu_torch must stay light (mirrors
tests/test_import_hygiene.py): no JAX, no JAX package, no safetensors, no
cv2, no triton; no CUDA context; no kernel build. Run in a fresh
interpreter, since this test process has imported JAX already.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_import_is_light(tmp_path):
    build = tmp_path / "build"
    code = (
        "import sys, torch;"
        "import posebyte_tpu_torch, posebyte_tpu_torch.core,"
        " posebyte_tpu_torch.ops, posebyte_tpu_torch.models,"
        " posebyte_tpu_torch.tracker, posebyte_tpu_torch.pipeline,"
        " posebyte_tpu_torch.pipeline.serving,"
        " posebyte_tpu_torch.pipeline.frontend,"
        " posebyte_tpu_torch.models.oracle,"
        " posebyte_tpu_torch.utils.synthetic;"
        "bad = [m for m in ('jax', 'flax', 'posebyte_tpu', 'safetensors',"
        " 'cv2', 'triton') if m in sys.modules];"
        "assert not bad, bad;"
        "assert not torch.cuda.is_initialized();"
        "print('CLEAN')"
    )
    env = {**os.environ, "POSEBYTE_CUDA_BUILD_DIR": str(build)}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr[-2000:]
    assert not build.exists()


def test_port_sources_name_no_jax():
    """No module of the port imports JAX, the JAX package, safetensors or
    cv2, and no kernel source pulls in PyTorch's extension headers."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|posebyte_tpu|"
                     r"safetensors|cv2)\b|cpp_extension|torch/extension\.h")
    roots = [os.path.join(REPO, "posebyte_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    hits = []
    for root in roots:
        files = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith((".py", ".cu", ".cuh"))]
        for path in files:
            with open(path) as fh:
                hits += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                         if pat.search(line)]
    assert not hits, hits
