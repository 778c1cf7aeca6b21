"""Operations of the Clas model (HybridBaseline: ResNet34, the integral
deconvolution head, the MLP_O box head) per image, counted from shapes as
``torch.utils.flop_counter.FlopCounterMode`` counts them: 2 x
multiply-adds of every convolution, transposed convolution, matrix
product and batched product; elementwise work, softmax and the integral's
sums are not counted. The backward pass computes each layer's weight
gradient, and its input gradient where the input needs one (not for the
image)."""
from __future__ import annotations

from typing import Dict, Tuple

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def clas_flops(image_size: Tuple[int, int], head: Dict, box: Dict) -> Dict[str, float]:
    """-> {"forward": per image, "backward": per image, "train": their sum}."""
    H, W = image_size
    fwd = bwd = 0.0

    def conv(cin, cout, k, hout, wout, first=False):
        nonlocal fwd, bwd
        f = 2.0 * cin * cout * k * k * hout * wout
        fwd += f
        bwd += f if first else 2 * f

    h, w = -(-H // 2), -(-W // 2)
    conv(3, 64, 7, h, w, first=True)
    h, w = -(-h // 2), -(-w // 2)  # max pool 3, stride 2, pad 1
    cin = 64
    for i, (width, n) in enumerate(STAGES):
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            ho, wo = -(-h // stride), -(-w // stride)
            conv(cin, width, 3, ho, wo)
            conv(width, width, 3, ho, wo)
            if stride != 1 or cin != width:
                conv(cin, width, 1, ho, wo)
            h, w, cin = ho, wo, width
    for f, k in zip(head["NUM_DECONV_FILTERS"], head["NUM_DECONV_KERNELS"]):
        g = 2.0 * cin * f * k * k * h * w  # each input pixel scatters a k x k x f patch
        fwd += g
        bwd += 2 * g
        h, w, cin = 2 * h, 2 * w, f
    fk = head["FINAL_CONV_KERNEL"]
    conv(cin, head["NCLASSES"] * head["DEPTH_RESOLUTION"], fk, h, w)
    widths = list(box["LAYERS_N"]) + [box["OUT_CHANNEL"]]
    for a, b in zip(widths[:-1], widths[1:]):
        fwd += 2.0 * a * b
        bwd += 4.0 * a * b
    corners = 2.0 * 3 * 3 * 8  # the box rotation applied to the 8 canonical corners
    fwd += corners
    bwd += corners  # the rotation's gradient; the corners need none
    return {"forward": fwd, "backward": bwd, "train": fwd + bwd}
