"""A toy network of four pyramid levels for the tests, the reference's
side: YOLOv8-pose's backbone with a stride-64 stage (Conv 3x3 s2, C2f)
before SPPF, as in yolov8-pose-p6.yaml, a neck over four levels built
from C2 blocks of its own, and the v8 pose head at each level."""
import torch

from portbench.reference.model import (bottleneck, c2f, conv_act,
                                       head_branch, sppf, up)

STRIDES = (8, 16, 32, 64)


def c2(cv, key, x):
    """Ultralytics' C2: a, b = split(cv1(x)); cv2(cat(m(a), b)), m the
    3x3-3x3 bottlenecks without a shortcut."""
    y = conv_act(cv, key + ".cv1", x)
    c = y.shape[1] // 2
    a, b = y[:, :c], y[:, c:]
    i = 0
    while f"{key}.m.{i}.cv1" in cv.w:
        a = bottleneck(cv, f"{key}.m.{i}", a, False)
        i += 1
    return conv_act(cv, key + ".cv2", torch.cat([a, b], 1))


def pyramid(cv, x):
    x = conv_act(cv, "b1", conv_act(cv, "b0", x, 2), 2)
    x = c2f(cv, "b2", x, True)
    p3 = c2f(cv, "b4", conv_act(cv, "b3", x, 2), True)
    p4 = c2f(cv, "b6", conv_act(cv, "b5", p3, 2), True)
    p5 = c2f(cv, "b8", conv_act(cv, "b7", p4, 2), True)
    x = c2f(cv, "b10", conv_act(cv, "b9", p5, 2), True)
    p6 = sppf(cv, "b11", x)
    n5 = c2(cv, "h14", torch.cat([up(p6), p5], 1))
    n4 = c2(cv, "h17", torch.cat([up(n5), p4], 1))
    o3 = c2(cv, "h20", torch.cat([up(n4), p3], 1))
    o4 = c2(cv, "h23", torch.cat([conv_act(cv, "h21", o3, 2), n4], 1))
    o5 = c2(cv, "h26", torch.cat([conv_act(cv, "h24", o4, 2), n5], 1))
    o6 = c2(cv, "h29", torch.cat([conv_act(cv, "h27", o5, 2), p6], 1))
    return o3, o4, o5, o6


def head(cv, i, x):
    cls = head_branch(cv, "cv3", i, x)
    return head_branch(cv, "cv2", i, x), cls, head_branch(cv, "cv4", i, x)
