"""YOLOv8-pose, Ultralytics' yolov8-pose.yaml: C2f blocks, SPPF, a neck
over three levels (strides 8, 16, 32) and the pose head's plain branches."""
import torch

from portbench.reference.model import c2f, conv_act, head_branch, sppf, up

STRIDES = (8, 16, 32)


def pyramid(cv, x):
    x = conv_act(cv, "b1", conv_act(cv, "b0", x, 2), 2)
    x = c2f(cv, "b2", x, True)
    p3 = c2f(cv, "b4", conv_act(cv, "b3", x, 2), True)
    p4 = c2f(cv, "b6", conv_act(cv, "b5", p3, 2), True)
    x = c2f(cv, "b8", conv_act(cv, "b7", p4, 2), True)
    p5 = sppf(cv, "b9", x)
    n4 = c2f(cv, "h12", torch.cat([up(p5), p4], 1), False)
    o3 = c2f(cv, "h15", torch.cat([up(n4), p3], 1), False)
    o4 = c2f(cv, "h18", torch.cat([conv_act(cv, "h16", o3, 2), n4], 1),
             False)
    o5 = c2f(cv, "h21", torch.cat([conv_act(cv, "h19", o4, 2), p5], 1),
             False)
    return o3, o4, o5


def head(cv, i, x):
    cls = head_branch(cv, "cv3", i, x)
    return head_branch(cv, "cv2", i, x), cls, head_branch(cv, "cv4", i, x)
