"""hardnet_roofline: HardNet's least time over the device work under the
program's DescTime spans, in %.

The least time is 2 x the convolutions' multiply-adds a patch (from the
layer list in the configuration's file, pbcore.roofline.conv_macs) x the
valid patches described (the final descriptors of both images, which
count every step's new views once) / 67 TFLOP/s.  Nothing to read where
the configuration runs no HardNet."""
from pbcore import roofline

NAME = "hardnet_roofline"
UNIT = "%"
SOURCE = "device_trace"


def flops(record) -> float:
    net = record["spec"].get("hardnet")
    if not net:
        return 0.0
    macs = roofline.conv_macs(net["convs"], int(net["patch"]))
    patches = sum(p["per_step"][-1]["descriptors1"] + p["per_step"][-1]["descriptors2"]
                  for p in record["pairs"] if p["per_step"])
    return 2.0 * macs * patches


def read(record):
    tr = record["trace"]
    dev = tr and tr["span_device_s"].get("DescTime")
    f = flops(record)
    if not dev or f <= 0:
        return None
    return 100.0 * f / roofline.F32_FLOPS / dev
