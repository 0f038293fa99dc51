"""The paper's CNN evaluation zoo (Table III / IV models).

Structures are the published architectures (YOLO backbones approximated as
their conv feature extractors); GOPs are the paper-reported per-inference
workloads used by the modeled-throughput benchmarks.
"""
from repro_torch.core.config import CNNConfig, ConvSpec as C

RESNET50 = CNNConfig(
    name="resnet50", input_hw=224, input_ch=3,
    stem_kernel=7, stem_stride=2, stem_ch=64,
    stages=(
        C("pool", kernel=3, stride=2),
        C("bottleneck", out_ch=256, kernel=3, stride=1, repeat=3),
        C("bottleneck", out_ch=512, kernel=3, stride=2, repeat=4),
        C("bottleneck", out_ch=1024, kernel=3, stride=2, repeat=6),
        C("bottleneck", out_ch=2048, kernel=3, stride=2, repeat=3),
    ), gops=8.19)

RESNET152 = CNNConfig(
    name="resnet152", input_hw=224, input_ch=3,
    stem_kernel=7, stem_stride=2, stem_ch=64,
    stages=(
        C("pool", kernel=3, stride=2),
        C("bottleneck", out_ch=256, kernel=3, stride=1, repeat=3),
        C("bottleneck", out_ch=512, kernel=3, stride=2, repeat=8),
        C("bottleneck", out_ch=1024, kernel=3, stride=2, repeat=36),
        C("bottleneck", out_ch=2048, kernel=3, stride=2, repeat=3),
    ), gops=21.8)

MOBILENET_V1 = CNNConfig(
    name="mobilenetv1", input_hw=224, input_ch=3,
    stem_kernel=3, stem_stride=2, stem_ch=32,
    stages=(
        C("dwsep", out_ch=64, kernel=3, stride=1, repeat=1),
        C("dwsep", out_ch=128, kernel=3, stride=2, repeat=2),
        C("dwsep", out_ch=256, kernel=3, stride=2, repeat=2),
        C("dwsep", out_ch=512, kernel=3, stride=2, repeat=6),
        C("dwsep", out_ch=1024, kernel=3, stride=2, repeat=2),
    ), gops=1.02)

MOBILENET_V2 = CNNConfig(
    name="mobilenetv2", input_hw=224, input_ch=3,
    stem_kernel=3, stem_stride=2, stem_ch=32,
    stages=(
        C("inverted", out_ch=16, kernel=3, stride=1, repeat=1, expand=1),
        C("inverted", out_ch=24, kernel=3, stride=2, repeat=2, expand=6),
        C("inverted", out_ch=32, kernel=3, stride=2, repeat=3, expand=6),
        C("inverted", out_ch=64, kernel=3, stride=2, repeat=4, expand=6),
        C("inverted", out_ch=96, kernel=3, stride=1, repeat=3, expand=6),
        C("inverted", out_ch=160, kernel=3, stride=2, repeat=3, expand=6),
        C("inverted", out_ch=320, kernel=3, stride=1, repeat=1, expand=6),
        C("conv", out_ch=1280, kernel=1, stride=1, repeat=1),
    ), gops=0.60)

EFFICIENTNET_B0 = CNNConfig(
    name="efficientnet", input_hw=224, input_ch=3,
    stem_kernel=3, stem_stride=2, stem_ch=32,
    stages=(
        C("inverted", out_ch=16, kernel=3, stride=1, repeat=1, expand=1),
        C("inverted", out_ch=24, kernel=3, stride=2, repeat=2, expand=6),
        C("inverted", out_ch=40, kernel=5, stride=2, repeat=2, expand=6),
        C("inverted", out_ch=80, kernel=3, stride=2, repeat=3, expand=6),
        C("inverted", out_ch=112, kernel=5, stride=1, repeat=3, expand=6),
        C("inverted", out_ch=192, kernel=5, stride=2, repeat=4, expand=6),
        C("inverted", out_ch=320, kernel=3, stride=1, repeat=1, expand=6),
        C("conv", out_ch=1280, kernel=1, stride=1, repeat=1),
    ), gops=4.7)

SQUEEZENET = CNNConfig(
    name="squeezenet", input_hw=224, input_ch=3,
    stem_kernel=3, stem_stride=2, stem_ch=64,
    stages=(
        C("pool", kernel=3, stride=2),
        C("fire", out_ch=128, kernel=3, stride=1, repeat=2),
        C("pool", kernel=3, stride=2),
        C("fire", out_ch=256, kernel=3, stride=1, repeat=2),
        C("pool", kernel=3, stride=2),
        C("fire", out_ch=384, kernel=3, stride=1, repeat=2),
        C("fire", out_ch=512, kernel=3, stride=1, repeat=2),
    ), gops=0.7)

YOLOV3 = CNNConfig(
    name="yolov3", input_hw=416, input_ch=3,
    stem_kernel=3, stem_stride=1, stem_ch=32,
    stages=(  # darknet-53 feature extractor
        C("conv", out_ch=64, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=64, kernel=3, stride=1, repeat=1),
        C("conv", out_ch=128, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=128, kernel=3, stride=1, repeat=2),
        C("conv", out_ch=256, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=256, kernel=3, stride=1, repeat=8),
        C("conv", out_ch=512, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=512, kernel=3, stride=1, repeat=8),
        C("conv", out_ch=1024, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=1024, kernel=3, stride=1, repeat=4),
    ), gops=65.9)

YOLOV5N = CNNConfig(
    name="yolov5n", input_hw=640, input_ch=3,
    stem_kernel=6, stem_stride=2, stem_ch=16,
    stages=(
        C("conv", out_ch=32, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=32, kernel=3, stride=1, repeat=1),
        C("conv", out_ch=64, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=64, kernel=3, stride=1, repeat=2),
        C("conv", out_ch=128, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=128, kernel=3, stride=1, repeat=3),
        C("conv", out_ch=256, kernel=3, stride=2, repeat=1),
        C("bottleneck", out_ch=256, kernel=3, stride=1, repeat=1),
    ), gops=4.6)

CNN_ZOO = {c.name: c for c in [
    RESNET50, RESNET152, MOBILENET_V1, MOBILENET_V2, EFFICIENTNET_B0,
    SQUEEZENET, YOLOV3, YOLOV5N]}

# Paper Table III reference FPS (XVDPU C32B6 and our 6PE+DWC / 8PE columns).
PAPER_TABLE3 = {
    # name: (gops, b4096, xvdpu_c32b6, ours_6pe_dwc, ours_8pe, ratio)
    "resnet50":     (8.19, 190.3, 2676.7, 3417.8, 4568.9, 1.27),
    "resnet152":    (21.8, 84.7, 1200.1, 1586.1, 2108.8, 1.32),
    "yolov3":       (65.9, 37.5, 286.8, 382.9, 472.2, 1.33),
    "squeezenet":   (0.7, 1500.8, 5827.0, 6658.9, 7664.4, 1.14),
    "efficientnet": (4.7, 319.0, 2167.1, 3976.5, 3675.7, 1.83),
    "yolov5n":      (4.6, 201.4, 397.6, 868.3, 1379.8, 2.18),
    "mobilenetv1":  (1.02, 993.5, 4913.3, 8787.8, 9123.1, 1.78),
    "mobilenetv2":  (0.60, 764.41, 4930.3, 6565.3, 8315.8, 1.33),
}
