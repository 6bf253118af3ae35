"""The port's socket front end (posebyte_tpu_torch/pipeline/frontend.py)
over a real loopback TCP socket, around the port's StreamServer on the CPU
with the oracle detector, against the JAX package's front end around its
own server with the same oracle heads: the JSON tracks for the same frames,
the wire protocol across packages (a JAX client on the port's server and
the port's client on the JAX server), isolated clients, BUSY backpressure,
protocol errors and the auto stepper.

Tolerances: track ids equal; bbox and keypoints within 1e-2 px (the JSON
rounds them to 2 decimals, and the two packages' decoded poses differ by a
few float32 ulps, which can move a value across a rounding boundary);
scores within 2e-6 relative. Every client socket has a timeout, so that a
hang fails instead of waiting.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.models.oracle import make_oracle_heads as j_oracle
from posebyte_tpu.parallel import make_mesh
from posebyte_tpu.pipeline import frontend as JF
from posebyte_tpu.pipeline.serving import StreamServer as JStreamServer

from posebyte_tpu_torch.models.oracle import make_oracle_heads
from posebyte_tpu_torch.ops.preprocess import letterbox_params
from posebyte_tpu_torch.pipeline import frontend as TF
from posebyte_tpu_torch.pipeline.serving import StreamServer

from test_torch_serving import H, HEAD1, TRK, W, configs, oracle_gt

torch.set_num_threads(2)

TIMEOUT = 60.0
BLANK = np.zeros((H, W, 3), np.uint8)      # the oracle ignores the pixels


def port_server():
    _, tcfg = configs(TRK)
    return StreamServer(8, (H, W), config=tcfg, params=HEAD1, device="cpu",
                        dtype=torch.float32, heads_fn=make_oracle_heads())


def gt_frame():
    """The oracle person in frame pixels."""
    gt = oracle_gt(1, scores=(0.9,))[0]
    scale, _, _, pad_x, pad_y = letterbox_params(W, H, 64)
    gt[:, :, :2] = (gt[:, :, :2] - np.float32([pad_x, pad_y])) / scale
    return gt


def client(cls, fe):
    cli = cls(*fe.address)
    cli._sock.settimeout(TIMEOUT)
    return cli


@pytest.fixture(scope="module")
def frontend():
    fe = TF.PoseServingFrontend(port_server(), max_queue=2, auto_step=False)
    yield fe
    fe.close()


@pytest.fixture(scope="module")
def jax_frontend():
    jcfg, _ = configs(TRK)
    srv = JStreamServer(num_streams=8, frame_shape=(H, W), config=jcfg,
                        mesh=make_mesh(8), params=HEAD1, dtype=jnp.float32,
                        heads_fn=j_oracle())
    fe = JF.PoseServingFrontend(srv, max_queue=2, auto_step=False)
    yield fe
    fe.close()


def assert_tracks_equal(got, want):
    assert len(got) == len(want)
    for g_frame, w_frame in zip(got, want):
        assert [t["id"] for t in g_frame] == [t["id"] for t in w_frame]
        for g, w in zip(g_frame, w_frame):
            np.testing.assert_allclose(g["score"], w["score"], rtol=2e-6)
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-2)
            np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                       atol=1e-2)


def run_episode(fe, cli_cls, n=3):
    cli = client(cli_cls, fe)
    sid = cli.open_stream()
    got = []
    for _ in range(n):
        assert cli.send_frame(sid, BLANK)
        assert fe.step_once() == 1
        got += cli.poll(sid)
    assert cli.poll(sid) == []                # drained
    cli.close_stream(sid)
    cli.close()
    return got


def test_tracking_roundtrip_over_socket(frontend):
    """Frames in over TCP -> tracks back in frame pixels at the oracle
    person, with one stable id."""
    got = run_episode(frontend, TF.PoseClient)
    assert len(got) == 3 and all(len(t) == 1 for t in got)
    assert {t[0]["id"] for t in got} == {1}
    for tracks in got:
        kp = np.asarray(tracks[0]["keypoints"], np.float32)
        np.testing.assert_allclose(kp[:, :2], gt_frame()[0][:, :2], atol=2.0)


def test_tracks_match_jax_frontend_across_clients(frontend, jax_frontend):
    """The JSON tracks of the port's front end equal the JAX front end's
    for the same frames, whichever package's client asks either server."""
    want = run_episode(jax_frontend, JF.PoseClient)
    assert_tracks_equal(run_episode(frontend, TF.PoseClient), want)
    assert_tracks_equal(run_episode(frontend, JF.PoseClient), want)
    assert_tracks_equal(run_episode(jax_frontend, TF.PoseClient), want)


def test_tracks_equal_server_outputs_unletterboxed(frontend):
    """What the socket returns is the server's own output, un-letterboxed
    by ops.preprocess.letterbox_params."""
    srv = port_server()
    sid = srv.open_stream()
    srv.submit(sid, BLANK)
    srv.step()
    out = srv.poll(sid)[0]
    scale, _, _, pad_x, pad_y = letterbox_params(W, H, 64)
    (tr,) = run_episode(frontend, TF.PoseClient, n=1)[0]
    d = int(np.nonzero(out["emit"])[0][0])
    kp = out["poses"][d].copy()
    kp[:, :2] = (kp[:, :2] - np.float32([pad_x, pad_y])) / scale
    assert tr["id"] == int(out["ids"][d])
    np.testing.assert_allclose(tr["keypoints"], kp, atol=5e-3)


def test_two_clients_isolated_streams(frontend):
    c1, c2 = client(TF.PoseClient, frontend), client(TF.PoseClient, frontend)
    s1, s2 = c1.open_stream(), c2.open_stream()
    assert s1 != s2
    c1.send_frame(s1, BLANK)
    frontend.step_once()
    assert len(c1.poll(s1)) == 1
    assert c2.poll(s2) == []                  # nothing leaked across
    c1.close_stream(s1)
    c2.close_stream(s2)
    c1.close()
    c2.close()


def test_backpressure_busy(frontend):
    """With the stepper paused, the (max_queue + 1)-th frame is refused
    with BUSY, not buffered; after a step the stream accepts again."""
    cli = client(TF.PoseClient, frontend)
    sid = cli.open_stream()
    assert cli.send_frame(sid, BLANK)
    assert cli.send_frame(sid, BLANK)
    assert not cli.send_frame(sid, BLANK)     # queue bound 2 -> BUSY
    frontend.step_once()
    assert cli.send_frame(sid, BLANK)
    while frontend.step_once():
        pass
    assert len(cli.poll(sid)) == 3
    assert cli.stats()["frames_in"] >= 3
    cli.close_stream(sid)
    cli.close()


def test_protocol_errors(frontend):
    cli = client(TF.PoseClient, frontend)
    with pytest.raises(RuntimeError):         # unopened stream
        cli.send_frame(99, BLANK)
    sid = cli.open_stream()
    with pytest.raises(RuntimeError):         # wrong frame geometry
        cli.send_frame(sid, np.zeros((10, 10, 3), np.uint8))
    with pytest.raises(RuntimeError):         # unknown op
        cli._call(9, sid)
    assert cli.stats()["open_streams"] >= 1
    cli.close_stream(sid)
    with pytest.raises(RuntimeError):         # double close
        cli.close_stream(sid)
    cli.close()
    raw = client(TF.PoseClient, frontend)     # bad magic: error, then EOF
    raw._sock.sendall(TF._REQ.pack(0x12345678, 1, -1, 0))
    status, _ = TF._REP.unpack(TF._recv_exact(raw._sock, TF._REP.size))
    assert status == TF.ST_ERR
    raw.close()


def test_auto_stepper_drives_device():
    """The stepper thread consumes queued frames with no explicit step
    calls, and close() stops it and the connections."""
    fe = TF.PoseServingFrontend(port_server(), max_queue=4, auto_step=True)
    try:
        cli = client(TF.PoseClient, fe)
        sid = cli.open_stream()
        for _ in range(3):
            assert cli.send_frame(sid, BLANK)
        got = []
        deadline = time.time() + TIMEOUT
        while len(got) < 3 and time.time() < deadline:
            got += cli.poll(sid)
            time.sleep(0.02)
        assert len(got) == 3
        assert fe.stats()["frames_tracked"] >= 3
        cli.close_stream(sid)
    finally:
        fe.close()
    assert not any(t.is_alive() for t in fe._threads)
    with pytest.raises((ConnectionError, OSError)):
        cli.stats()
    cli.close()
