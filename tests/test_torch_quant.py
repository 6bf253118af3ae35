"""The port's int8 quantisation (posebyte_tpu_torch/models/quant.py, the
recorder in models/layers.py, int8 checkpoints in models/weights.py)
against posebyte_tpu/models/quant.py on the trained yolov8n-pose 256
checkpoint, calibrated at input 64.

Tolerances: none for the int8 weights, their scales, the skip policy, the
KL threshold and the histograms' counts on the same values, the cache and
the checkpoints. Calibrated act_scales within 1e-4 relative of JAX's: the
same order statistics, or the same histogram bins, of activations that
oneDNN's and XLA's float32 convolutions compute in different summation
orders (~1e-6 apart). The entropy search is discontinuous in its input:
on one batch of 16 frames the two histograms of one conv (head.cv4[0].2)
differ in 32 of 52,224 counts, which moves its KL minimum by one near-tied
bin (1.7%); so up to 2 of the 59 entropy scales may differ by up to 5%.
With a second batch, JAX's histogram doubled its bin width where the
port's did not on 20 convs (a later batch's maximum within an ulp of the
first's), so the entropy comparison runs on one batch.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open

from posebyte_tpu.models import layers as JL
from posebyte_tpu.models import quant as JQ
from posebyte_tpu.models.weights import save_params as j_save_params
from posebyte_tpu.models.yolo_pose import init_params

from posebyte_tpu_torch.models import layers as L
from posebyte_tpu_torch.models import quant as Q
from posebyte_tpu_torch.models import weights as W
from posebyte_tpu_torch.utils.synthetic import calibration_frames

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")
NAME = "yolov8n-pose"
RTOL = 1e-4


def jax_tree(flat: dict, name: str = NAME):
    """The port's flat params as the JAX package's tree, HWIO, filled as
    posebyte_tpu.models.weights.load_params fills it from a file (the tree's
    structure from init_params by eval_shape, which skips its random
    initialisation: 1 s instead of 30)."""
    tree = jax.eval_shape(lambda k: init_params(k, name),
                          jax.random.PRNGKey(0))

    def leaf(v):
        v = np.asarray(v)
        return jnp.asarray(np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4
                           else v)

    def fill(node, prefix):
        if isinstance(node, dict):
            if set(node) == {"w", "b"}:
                return {f: leaf(flat[prefix + f])
                        for f in ("w", "scale", "act_scale", "b")
                        if prefix + f in flat}
            return {k: fill(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):      # v11's (kind, params)
            return type(node)(fill(v, f"{prefix}{i}.")
                              for i, v in enumerate(node))
        if hasattr(node, "shape"):
            return leaf(flat[prefix[:-1]])
        return node                                   # static metadata

    return fill(tree, "")


@pytest.fixture(scope="module")
def jax_params():
    return jax_tree(W.load_params(ASSET)[0])


@pytest.fixture(scope="module")
def port_params():
    return W.load_params(ASSET)[0]


@pytest.fixture(scope="module")
def images():
    # two batches of 16, as both packages group them
    return calibration_frames(32, 64, seed=5)


N_IMAGES = {"percentile": 32, "entropy": 16}


def _jax_convs(tree):
    return {p: jax.tree.map(np.asarray, n)
            for p, n in JQ.conv_paths(tree).items()}


def test_quantize_params_matches_jax(jax_params, port_params):
    """Bit for bit: the int8 weights (HWIO -> OIHW), the per-channel
    scales and the biases, with b0-b4 left float."""
    jq = _jax_convs(JQ.quantize_params(jax_params))
    pq = Q.quantize_params(port_params)
    paths = Q.conv_paths(pq)
    assert list(paths) == list(jq)                  # same paths, same order
    n_int8 = 0
    for path, key in paths.items():
        jn = jq[path]
        skipped = key.split(".")[0] in Q.PARTIAL_QUANT_SKIP
        assert ("scale" in jn) == (not skipped) == (key + ".scale" in pq)
        want_w = np.transpose(jn["w"], (3, 2, 0, 1))
        assert pq[key + ".w"].dtype == want_w.dtype
        np.testing.assert_array_equal(pq[key + ".w"], want_w)
        np.testing.assert_array_equal(pq[key + ".b"], jn["b"])
        if not skipped:
            np.testing.assert_array_equal(pq[key + ".scale"], jn["scale"])
            n_int8 += 1
    assert n_int8 == 59 and Q.quantize_params(pq).keys() == pq.keys()


def test_jax_paths_of_the_v8_tree(port_params):
    paths = Q.conv_paths(port_params)
    assert paths["b6.m[0].cv1"] == "b6.m.0.cv1"
    assert paths["head.cv2[0].0"] == "head.cv2.0.0"
    assert paths["head.cv4[2].2"] == "head.cv4.2.2"
    assert Q.jax_path("b9.cv2") == "b9.cv2"


def test_kl_threshold_and_histogram_match_jax():
    """The entropy calibration's two halves on the same values: the
    streaming histogram (growing range, merged bins) and the KL search."""
    rng = np.random.default_rng(1)
    jh, ph = JL._EntropyHist(), L._EntropyHist()
    for scale in (1.0, 3.0, 0.5, 9.0):
        x = np.abs(rng.standard_t(3, 50_000) * scale).astype(np.float32)
        jh.update(x)
        ph.update(x)
    np.testing.assert_array_equal(ph.counts, jh.counts)
    assert ph.width == jh.width
    assert Q._kl_threshold(ph.counts, ph.width) == JQ._kl_threshold(
        jh.counts, jh.width)
    assert Q._kl_threshold(np.zeros(2048, np.int64), 1.0) == 0.0


def test_percentile_matches_jnp_percentile():
    """percentile_999 is jnp.percentile's float32 linear interpolation
    under jit, bit for bit. Called eagerly, as JAX's calibration calls it, jnp.percentile places
    the position with q one float32 step lower (0.99899995): within 2e-6
    relative of it."""
    rng = np.random.default_rng(2)
    jitted = jax.jit(lambda a: jnp.percentile(a, 99.9))
    for n in (1, 7, 1000, 300_001):
        x = np.abs(rng.normal(0, 1, n)).astype(np.float32)
        got = L.percentile_999(torch.from_numpy(x))
        assert got == float(jitted(x))
        assert got == pytest.approx(float(jnp.percentile(jnp.asarray(x),
                                                         99.9)), rel=2e-6)


@pytest.mark.parametrize("method", ["percentile", "entropy"])
def test_calibrate_activations_matches_jax(jax_params, port_params, images,
                                           method):
    """The same act_scale on every quantised conv as JAX's eager
    calibration on the same images (stated tolerances)."""
    imgs = images[:N_IMAGES[method]]
    jq = JQ.calibrate_activations(JQ.quantize_params(jax_params), NAME,
                                  imgs, method=method)
    pq = Q.calibrate_activations(Q.quantize_params(port_params), NAME,
                                 imgs, method=method, device="cpu")
    jconvs = _jax_convs(jq)
    rel = []
    for path, key in Q.conv_paths(pq).items():
        assert ("act_scale" in jconvs[path]) == (key + ".act_scale" in pq)
        if key + ".act_scale" in pq:
            got = pq[key + ".act_scale"]
            assert got.dtype == np.float32 and got.shape == ()
            want = float(jconvs[path]["act_scale"])
            rel.append(abs(float(got) - want) / want)
    assert len(rel) == 59
    off = [r for r in rel if r > RTOL]
    assert len(off) <= (2 if method == "entropy" else 0), off
    assert max(rel) <= 0.05
    assert L._CALIBRATION_RECORDER is None


def test_calibrate_sets_the_numeric_settings(port_params, images):
    """Calibration turns TF32 off itself, as a pipeline does: its scales
    must not hang on whether a pipeline was made before it."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    Q.calibrate_activations(Q.quantize_params(port_params), NAME,
                            images[:1], device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_calibrate_rejects_unknown_method(port_params, images):
    with pytest.raises(ValueError, match="calibration method"):
        Q.calibrate_activations(Q.quantize_params(port_params), NAME,
                                images, method="minmax", device="cpu")


def test_calibration_cache_round_trips_between_packages(
        tmp_path, jax_params, port_params):
    """A cache written by either package loads in the other, scale for
    scale (JAX's dotted paths with [i] list items)."""
    rng = np.random.default_rng(4)
    pq = Q.quantize_params(port_params)
    for key in Q.conv_paths(pq).values():
        if key + ".scale" in pq:
            pq[key + ".act_scale"] = np.asarray(rng.uniform(0.01, 0.2),
                                                np.float32)
    port_cache = tmp_path / "port.json"
    assert Q.save_calibration_cache(pq, str(port_cache)) == 59
    jq = JQ.quantize_params(jax_params)
    assert JQ.load_calibration_cache(jq, str(port_cache)) == 59
    for path, key in Q.conv_paths(pq).items():
        jn = JQ.conv_paths(jq)[path]
        if "act_scale" in jn:
            assert float(jn["act_scale"]) == float(pq[key + ".act_scale"])
    jax_cache = tmp_path / "jax.json"
    assert JQ.save_calibration_cache(jq, str(jax_cache)) == 59
    assert json.loads(jax_cache.read_text()) == json.loads(
        port_cache.read_text())
    back = Q.quantize_params(port_params)
    assert Q.load_calibration_cache(back, str(jax_cache)) == 59
    for key in Q.conv_paths(pq).values():
        if key + ".act_scale" in pq:
            assert back[key + ".act_scale"] == pq[key + ".act_scale"]


def test_int8_checkpoints_load_across_packages(tmp_path, jax_params,
                                               port_params):
    """An int8 checkpoint written by the JAX package's save_params loads in
    the port (int8 weights stay int8, HWIO -> OIHW; scales float32), and
    the port's save_params writes the same file back (names, types,
    shapes, values and metadata), which the JAX package's load_params
    reads."""
    jq = JQ.quantize_params(jax_params)
    for node in JQ.conv_paths(jq).values():
        if "scale" in node:
            node["act_scale"] = jnp.asarray(0.05, jnp.float32)
    path = str(tmp_path / "jax_int8.safetensors")
    j_save_params(jq, path, NAME)
    got, name = W.load_params(path)
    assert name == NAME
    want = Q.quantize_params(port_params)
    for key in Q.conv_paths(want).values():
        if key + ".scale" in want:
            want[key + ".act_scale"] = np.asarray(0.05, np.float32)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    tree = jax.tree.map(np.asarray, jq)
    assert W.params_from_jax(tree).keys() == want.keys()
    back = str(tmp_path / "port_int8.safetensors")
    W.save_params(got, back, NAME)
    with safe_open(back, framework="numpy") as f, \
            safe_open(path, framework="numpy") as g:
        assert f.metadata() == g.metadata()
        assert set(f.keys()) == set(g.keys())
        for k in g.keys():
            a, b = f.get_tensor(k), g.get_tensor(k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b)


def test_calibrate_and_quantize_sources(tmp_path, port_params):
    """The sources: synthetic frames (the JAX package's seed-0 noise,
    calibrated as above and written to the cache), the cache (no images),
    and a calib_dir that holds no image, which leaves weight-only int8 as
    in the JAX package (tests/test_torch_cli.py calibrates from images);
    without a source, weight-only int8."""
    cache = str(tmp_path / "cache.json")
    pq = Q.calibrate_and_quantize(port_params, NAME, input_size=64,
                                  cache_path=cache, synthetic_fallback=True,
                                  n_synthetic=4, device="cpu")
    noise = np.random.default_rng(0).uniform(0.0, 1.0, (4, 64, 64, 3)) \
        .astype(np.float32)
    want = Q.calibrate_activations(Q.quantize_params(port_params), NAME,
                                   noise, device="cpu")
    assert pq.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(pq[k], v)
    again = Q.calibrate_and_quantize(port_params, NAME, cache_path=cache)
    for k, v in pq.items():
        np.testing.assert_array_equal(again[k], v)
    weight_only = Q.calibrate_and_quantize(port_params, NAME)
    assert not any(k.endswith(".act_scale") for k in weight_only)
    no_images = Q.calibrate_and_quantize(port_params, NAME,
                                         calib_dir=str(tmp_path))
    assert not any(k.endswith(".act_scale") for k in no_images)


# ---- YOLO11 ---------------------------------------------------------------

V11_ASSET = os.path.join(os.path.dirname(ASSET),
                         "yolo11n-pose-synthetic640.safetensors")
V11 = "yolo11n-pose"


@pytest.fixture(scope="module")
def v11_params():
    flat, name = W.load_params(V11_ASSET)
    assert name == V11
    return flat, jax_tree(flat, V11)


def _quantised(params):
    """The conv keys outside PARTIAL_QUANT_SKIP (b0-b4)."""
    return [k for k in Q.conv_paths(params).values()
            if k.split(".")[0] not in Q.PARTIAL_QUANT_SKIP]


def test_jax_path_of_v11_keys():
    """C3k2 holds inner block i as a (kind, params) tuple: the port's
    "m.{i}.1" is the JAX path's m[i][1], also inside a C3k's own list;
    the v11 head's keys stay dict keys."""
    assert Q.jax_path("b6.m.0.1.cv1") == "b6.m[0][1].cv1"
    assert Q.jax_path("b6.m.0.1.m.1.cv2") == "b6.m[0][1].m[1].cv2"
    assert Q.jax_path("h13.m.1.1.cv2") == "h13.m[1][1].cv2"
    assert Q.jax_path("b10.m.0.attn.pe") == "b10.m[0].attn.pe"
    assert Q.jax_path("head.cv3.2.0_dw") == "head.cv3[2].0_dw"
    assert Q.jax_path("b2.m.1.cv1") == "b2.m[1].cv1"          # v8's C2f


@pytest.mark.parametrize("name", ["yolo11n-pose", "yolo11m-pose"])
def test_conv_paths_of_the_v11_tree_match_jax(v11_params, name):
    """conv_paths on a v11 flat dict: JAX's paths, in JAX's order (dict
    keys sorted as strings: the head's "0_dw" < "0_pw" < "1_dw" < "1_pw" <
    "2" sit where list indices sit elsewhere)."""
    if name == V11:
        flat, tree = v11_params
    else:
        tree = jax.eval_shape(lambda k: init_params(k, name),
                              jax.random.PRNGKey(0))
        flat = W.params_from_jax(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), tree))
    paths = Q.conv_paths(flat)
    assert list(paths) == list(JQ.conv_paths(tree))
    assert paths["head.cv3[1].1_dw"] == "head.cv3.1.1_dw"
    assert paths["b8.m[0][1].m[1].cv2"] == "b8.m.0.1.m.1.cv2"


def test_quantize_params_v11_matches_jax(v11_params):
    """Bit for bit on yolo11n-pose: every conv outside b0-b4 int8, the
    seven depthwise convs (the head's *_dw, the attention's pe) included."""
    flat, tree = v11_params
    jq = _jax_convs(JQ.quantize_params(tree))
    pq = Q.quantize_params(flat)
    paths = Q.conv_paths(pq)
    assert list(paths) == list(jq)
    n_int8 = n_dw = 0
    for path, key in paths.items():
        jn = jq[path]
        np.testing.assert_array_equal(pq[key + ".w"],
                                      np.transpose(jn["w"], (3, 2, 0, 1)))
        np.testing.assert_array_equal(pq[key + ".b"], jn["b"])
        assert ("scale" in jn) == (key + ".scale" in pq)
        if "scale" in jn:
            np.testing.assert_array_equal(pq[key + ".scale"], jn["scale"])
            n_int8 += 1
            n_dw += L.is_depthwise(key)
    assert (n_int8, n_dw) == (len(_quantised(pq)), 7)


def test_calibrate_v11_matches_jax(v11_params):
    """Percentile calibration of yolo11n-pose on the same images: an
    act_scale on every quantised conv, the depthwise ones included, within
    RTOL of JAX's."""
    flat, tree = v11_params
    imgs = calibration_frames(4, 64, seed=5)
    jconvs = _jax_convs(JQ.calibrate_activations(JQ.quantize_params(tree),
                                                 V11, imgs))
    pq = Q.calibrate_activations(Q.quantize_params(flat), V11, imgs,
                                 device="cpu")
    n = 0
    for path, key in Q.conv_paths(pq).items():
        assert ("act_scale" in jconvs[path]) == (key + ".act_scale" in pq)
        if key + ".act_scale" in pq:
            want = float(jconvs[path]["act_scale"])
            assert abs(float(pq[key + ".act_scale"]) - want) <= RTOL * want
            n += 1
    assert n == len(_quantised(pq))


def test_calibration_cache_v11_round_trips_between_packages(tmp_path,
                                                            v11_params):
    """A v11 cache written by either package loads in the other, scale
    for scale, and the two packages write the same JSON."""
    flat, tree = v11_params
    rng = np.random.default_rng(7)
    pq = Q.quantize_params(flat)
    for key in Q.conv_paths(pq).values():
        if key + ".scale" in pq:
            pq[key + ".act_scale"] = np.asarray(rng.uniform(0.01, 0.2),
                                                np.float32)
    port_cache = tmp_path / "port.json"
    n = Q.save_calibration_cache(pq, str(port_cache))
    jq = JQ.quantize_params(tree)
    assert JQ.load_calibration_cache(jq, str(port_cache)) == n == \
        len(_quantised(pq))
    jax_cache = tmp_path / "jax.json"
    assert JQ.save_calibration_cache(jq, str(jax_cache)) == n
    assert json.loads(jax_cache.read_text()) == json.loads(
        port_cache.read_text())
    back = Q.quantize_params(flat)
    assert Q.load_calibration_cache(back, str(jax_cache)) == n
    for key in Q.conv_paths(pq).values():
        if key + ".act_scale" in pq:
            assert back[key + ".act_scale"] == pq[key + ".act_scale"]
