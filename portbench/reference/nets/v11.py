"""YOLO11-pose, Ultralytics' yolo11-pose.yaml: C3k2 blocks, SPPF and
C2PSA attention, a neck over three levels (strides 8, 16, 32), and a pose
head whose class branches are depthwise-separable."""
import torch
import torch.nn.functional as F

from portbench.reference.model import (c2psa, c3k2, conv_act, head_branch,
                                       sppf, up)

STRIDES = (8, 16, 32)


def pyramid(cv, x):
    x = conv_act(cv, "b1", conv_act(cv, "b0", x, 2), 2)
    x = c3k2(cv, "b2", x)
    p3 = c3k2(cv, "b4", conv_act(cv, "b3", x, 2))
    p4 = c3k2(cv, "b6", conv_act(cv, "b5", p3, 2))
    x = c3k2(cv, "b8", conv_act(cv, "b7", p4, 2))
    p5 = c2psa(cv, "b10", sppf(cv, "b9", x))
    n4 = c3k2(cv, "h13", torch.cat([up(p5), p4], 1))
    o3 = c3k2(cv, "h16", torch.cat([up(n4), p3], 1))
    o4 = c3k2(cv, "h19", torch.cat([conv_act(cv, "h17", o3, 2), n4], 1))
    o5 = c3k2(cv, "h22", torch.cat([conv_act(cv, "h20", o4, 2), p5], 1))
    return o3, o4, o5


def head(cv, i, x):
    k = f"head.cv3.{i}"
    c = F.silu(cv(f"{k}.0_dw", x, 1, x.shape[1]))
    c = conv_act(cv, f"{k}.0_pw", c)
    c = F.silu(cv(f"{k}.1_dw", c, 1, c.shape[1]))
    c = conv_act(cv, f"{k}.1_pw", c)
    cls = cv(f"{k}.2", c)
    return head_branch(cv, "cv2", i, x), cls, head_branch(cv, "cv4", i, x)
