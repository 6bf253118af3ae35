"""YOLOv8-pose's convs, Ultralytics' yolov8-pose.yaml: C2f blocks, SPPF,
a neck over three levels (strides 8, 16, 32), the pose head."""


def build(net):
    ch, n = net.ch, net.n
    hw = net.conv("b0", 3, ch(64), 3, net.cfg["input_size"], 2)
    hw = net.conv("b1", ch(64), ch(128), 3, hw, 2)
    net.c2f("b2", ch(128), ch(128), n(3), hw)
    h3 = net.conv("b3", ch(128), ch(256), 3, hw, 2)
    net.c2f("b4", ch(256), ch(256), n(6), h3)
    h4 = net.conv("b5", ch(256), ch(512), 3, h3, 2)
    net.c2f("b6", ch(512), ch(512), n(6), h4)
    h5 = net.conv("b7", ch(512), ch(1024), 3, h4, 2)
    net.c2f("b8", ch(1024), ch(1024), n(3), h5)
    net.sppf("b9", ch(1024), ch(1024), h5)
    net.c2f("h12", ch(1024) + ch(512), ch(512), n(3), h4)
    net.c2f("h15", ch(512) + ch(256), ch(256), n(3), h3)
    net.conv("h16", ch(256), ch(256), 3, h3, 2)
    net.c2f("h18", ch(256) + ch(512), ch(512), n(3), h4)
    net.conv("h19", ch(512), ch(512), 3, h4, 2)
    net.c2f("h21", ch(512) + ch(1024), ch(1024), n(3), h5)
    net.head((ch(256), ch(512), ch(1024)), (h3, h4, h5), False)
