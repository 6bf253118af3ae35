"""YOLO11-pose's convs and attention products, Ultralytics'
yolo11-pose.yaml: C3k2 blocks, SPPF, C2PSA, a neck over three levels
(strides 8, 16, 32), the pose head with depthwise class branches."""


def build(net):
    ch, n = net.ch, net.n
    hw = net.conv("b0", 3, ch(64), 3, net.cfg["input_size"], 2)
    hw = net.conv("b1", ch(64), ch(128), 3, hw, 2)
    net.c3k2("b2", ch(128), ch(256), n(2), False, hw, e=0.25)
    h3 = net.conv("b3", ch(256), ch(256), 3, hw, 2)
    net.c3k2("b4", ch(256), ch(512), n(2), False, h3, e=0.25)
    h4 = net.conv("b5", ch(512), ch(512), 3, h3, 2)
    net.c3k2("b6", ch(512), ch(512), n(2), True, h4)
    h5 = net.conv("b7", ch(512), ch(1024), 3, h4, 2)
    net.c3k2("b8", ch(1024), ch(1024), n(2), True, h5)
    net.sppf("b9", ch(1024), ch(1024), h5)
    net.c2psa("b10", ch(1024), n(2), h5)
    net.c3k2("h13", ch(1024) + ch(512), ch(512), n(2), False, h4)
    net.c3k2("h16", ch(512) + ch(512), ch(256), n(2), False, h3)
    net.conv("h17", ch(256), ch(256), 3, h3, 2)
    net.c3k2("h19", ch(256) + ch(512), ch(512), n(2), False, h4)
    net.conv("h20", ch(512), ch(512), 3, h4, 2)
    net.c3k2("h22", ch(512) + ch(1024), ch(1024), n(2), True, h5)
    net.head((ch(256), ch(512), ch(1024)), (h3, h4, h5), True)
