"""A toy network of four pyramid levels for the tests, the conv table's
side (toy_nets/reference.py is the forward): YOLOv8-pose's backbone with
a stride-64 stage, a neck over four levels of C2 blocks, the v8 head."""


def c2(net, key, cin, cout, n, hw):
    c = int(cout * 0.5)
    net.conv(key + ".cv1", cin, 2 * c, 1, hw)
    for i in range(n):
        net.bottleneck(f"{key}.m.{i}", c, c, c, hw)
    net.conv(key + ".cv2", 2 * c, cout, 1, hw)


def build(net):
    ch, n = net.ch, net.n
    hw = net.conv("b0", 3, ch(64), 3, net.cfg["input_size"], 2)
    hw = net.conv("b1", ch(64), ch(128), 3, hw, 2)
    net.c2f("b2", ch(128), ch(128), n(3), hw)
    h3 = net.conv("b3", ch(128), ch(256), 3, hw, 2)
    net.c2f("b4", ch(256), ch(256), n(6), h3)
    h4 = net.conv("b5", ch(256), ch(512), 3, h3, 2)
    net.c2f("b6", ch(512), ch(512), n(6), h4)
    h5 = net.conv("b7", ch(512), ch(768), 3, h4, 2)
    net.c2f("b8", ch(768), ch(768), n(3), h5)
    h6 = net.conv("b9", ch(768), ch(1024), 3, h5, 2)
    net.c2f("b10", ch(1024), ch(1024), n(3), h6)
    net.sppf("b11", ch(1024), ch(1024), h6)
    c2(net, "h14", ch(1024) + ch(768), ch(768), n(3), h5)
    c2(net, "h17", ch(768) + ch(512), ch(512), n(3), h4)
    c2(net, "h20", ch(512) + ch(256), ch(256), n(3), h3)
    net.conv("h21", ch(256), ch(256), 3, h3, 2)
    c2(net, "h23", ch(256) + ch(512), ch(512), n(3), h4)
    net.conv("h24", ch(512), ch(512), 3, h4, 2)
    c2(net, "h26", ch(512) + ch(768), ch(768), n(3), h5)
    net.conv("h27", ch(768), ch(768), 3, h5, 2)
    c2(net, "h29", ch(768) + ch(1024), ch(1024), n(3), h6)
    net.head((ch(256), ch(512), ch(768), ch(1024)), (h3, h4, h5, h6), False)
