"""The forward's operations, counted from the configuration's published
layer shapes (the network its `family` names, portbench/work/nets/
<family>.py: v8 Ultralytics' yolov8-pose.yaml, v11 yolo11-pose.yaml, at
the file's depth, width and channel cap), never from the program. The
network's file is written apart from the reference's
(portbench/reference/nets/), so that the two check each other.

conv_table(config) lists every conv of the network with its key (the
checkpoint's), input and output channels, kernel, stride, groups and
output size at the configuration's input; matmul_ops(config) the
attention's batched products. Operations are 2 per multiply-add, as
torch.utils.flop_counter counts them; biases, activations, pooling and
the decode are not counted.
"""
from __future__ import annotations

import dataclasses
import math
import os

from portbench.harness.spec import load_module

# the root of the checkout this file was loaded from
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Conv:
    key: str
    cin: int
    cout: int
    k: int
    stride: int
    groups: int
    hw_in: int

    @property
    def hw_out(self) -> int:
        return (self.hw_in + 2 * (self.k // 2) - self.k) // self.stride + 1

    def ops(self, batch: int = 1) -> int:
        return 2 * batch * self.cout * self.hw_out ** 2 \
            * (self.cin // self.groups) * self.k * self.k


class _Net:
    def __init__(self, config):
        self.cfg = config
        self.convs = []
        self.mm = []                 # (batch-free ops) of attention products

    def ch(self, c):
        c = min(c, self.cfg["max_channels"])
        return max(8, math.ceil(c * self.cfg["width_multiple"] / 8) * 8)

    def n(self, n):
        return max(1, round(n * self.cfg["depth_multiple"]))

    def conv(self, key, cin, cout, k, hw, stride=1, groups=1):
        c = Conv(key, cin, cout, k, stride, groups, hw)
        self.convs.append(c)
        return c.hw_out

    def bottleneck(self, key, cin, cout, hidden, hw):
        self.conv(key + ".cv1", cin, hidden, 3, hw)
        self.conv(key + ".cv2", hidden, cout, 3, hw)

    def c2f(self, key, cin, cout, n, hw):
        c = int(cout * 0.5)
        self.conv(key + ".cv1", cin, 2 * c, 1, hw)
        for i in range(n):
            self.bottleneck(f"{key}.m.{i}", c, c, c, hw)
        self.conv(key + ".cv2", (2 + n) * c, cout, 1, hw)

    def c3k(self, key, cin, cout, hw):
        c = int(cout * 0.5)
        self.conv(key + ".cv1", cin, c, 1, hw)
        self.conv(key + ".cv2", cin, c, 1, hw)
        self.conv(key + ".cv3", 2 * c, cout, 1, hw)
        for i in range(2):
            self.bottleneck(f"{key}.m.{i}", c, c, c, hw)

    def c3k2(self, key, cin, cout, n, c3k, hw, e=0.5):
        c = int(cout * e)
        self.conv(key + ".cv1", cin, 2 * c, 1, hw)
        for i in range(n):
            if c3k:
                self.c3k(f"{key}.m.{i}.1", c, c, hw)
            else:
                self.bottleneck(f"{key}.m.{i}.1", c, c, int(c * 0.5), hw)
        self.conv(key + ".cv2", (2 + n) * c, cout, 1, hw)

    def sppf(self, key, cin, cout, hw):
        self.conv(key + ".cv1", cin, cin // 2, 1, hw)
        self.conv(key + ".cv2", cin // 2 * 4, cout, 1, hw)

    def c2psa(self, key, c1, n, hw):
        c = int(c1 * 0.5)
        heads = max(1, c // 64)
        kd = c // heads // 2
        hd = c // heads
        self.conv(key + ".cv1", c1, 2 * c, 1, hw)
        for i in range(n):
            m = f"{key}.m.{i}"
            self.conv(m + ".attn.qkv", c, c + 2 * kd * heads, 1, hw)
            self.conv(m + ".attn.pe", c, c, 3, hw, groups=c)
            self.conv(m + ".attn.proj", c, c, 1, hw)
            self.conv(m + ".ffn1", c, 2 * c, 1, hw)
            self.conv(m + ".ffn2", 2 * c, c, 1, hw)
            N = hw * hw
            self.mm += [2 * heads * N * N * kd, 2 * heads * hd * N * N]
        self.conv(key + ".cv2", 2 * c, c1, 1, hw)

    def head(self, chs, hws, depthwise_cls):
        """The pose head over the levels' channels and sizes, with
        depthwise-separable class branches where depthwise_cls."""
        reg = 4 * self.cfg["reg_max"]
        nk = self.cfg["kpt_shape"][0] * self.cfg["kpt_shape"][1]
        c2 = max(16, chs[0] // 4, reg)
        c3 = max(chs[0], min(self.cfg["nc"], 100))
        c4 = max(chs[0] // 4, nk)
        for i, (ch, hw) in enumerate(zip(chs, hws)):
            self.conv(f"head.cv2.{i}.0", ch, c2, 3, hw)
            self.conv(f"head.cv2.{i}.1", c2, c2, 3, hw)
            self.conv(f"head.cv2.{i}.2", c2, reg, 1, hw)
            k = f"head.cv3.{i}"
            if depthwise_cls:
                self.conv(k + ".0_dw", ch, ch, 3, hw, groups=ch)
                self.conv(k + ".0_pw", ch, c3, 1, hw)
                self.conv(k + ".1_dw", c3, c3, 3, hw, groups=c3)
                self.conv(k + ".1_pw", c3, c3, 1, hw)
            else:
                self.conv(k + ".0", ch, c3, 3, hw)
                self.conv(k + ".1", c3, c3, 3, hw)
            self.conv(k + ".2", c3, self.cfg["nc"], 1, hw)
            self.conv(f"head.cv4.{i}.0", ch, c4, 3, hw)
            self.conv(f"head.cv4.{i}.1", c4, c4, 3, hw)
            self.conv(f"head.cv4.{i}.2", c4, nk, 1, hw)


def network(family: str):
    """The conv table of `family`: portbench/work/nets/<family>.py
    beside this file, whose build(net) adds the network's convs and
    attention products to a _Net in the forward's order."""
    return load_module("work/nets", family, _ROOT)


def _build(config) -> _Net:
    net = _Net(config)
    network(config["family"]).build(net)
    return net


def conv_table(config) -> list:
    return _build(config).convs


def matmul_ops(config, batch: int = 1) -> int:
    return batch * sum(_build(config).mm)


def is_quantised(config, conv: Conv) -> bool:
    q = config.get("quant")
    return q is not None and conv.key.split(".")[0] not in q["skip"]


def forward_ops(config, batch: int = 1) -> int:
    """Operations of one forward of `batch` images."""
    return sum(c.ops(batch) for c in conv_table(config)) \
        + matmul_ops(config, batch)


def least_time(config, peaks: dict, batch: int = 1) -> float:
    """Seconds the forward's operations need at the card's peaks: the
    quantised convs at the int8 rate, every other conv and the attention
    products at the bf16 rate."""
    int8 = sum(c.ops(batch) for c in conv_table(config)
               if is_quantised(config, c))
    other = forward_ops(config, batch) - int8
    return int8 / peaks["int8_ops_s"] + other / peaks["bf16_ops_s"]
