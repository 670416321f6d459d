#!/usr/bin/env python3
"""ResNet-50's train step by activation layout, timed in turns on one NVIDIA card.

    python3 resnet_layout_ab.py [--seed 0]

Runs ``chip_smoke.py`` phase 26 (b)'s step (``resnet50``, 224x224, bf16
convolutions, batch 64, AdamW; 3 warm-up and 10 timed steps and a
profiled window of two, ``cudnn.benchmark`` on) with the module's
activations laid out three ways, in turns, the first again last:

* ``channels_last+group_norm``: the module as it is (NCHW tensors in
  channels-last memory, ``F.group_norm``);
* ``nchw+group_norm``: contiguous NCHW activations and OIHW kernels;
* ``channels_last+nhwc_norm``: channels-last, the norm's statistics taken
  in NHWC order with ``torch.var_mean`` in place of ``F.group_norm``.

Prints one JSON line a turn (step ms, images/s, ``mfu``, peak memory, the
device ms a step and the elementwise kernels' share), then the card's name
and power limit. Imports nothing of JAX; exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  HERE / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variants(torch):
    """Each layout as (Conv.forward, GroupNorm.forward, ResNet.forward)."""
    import torch.nn.functional as F

    from tpusystem_torch.models import resnet

    def conv_nchw(self, hidden, dtype):
        weight = self.kernel.to(dtype).permute(3, 2, 0, 1).contiguous()
        hidden, padding = resnet._pad_same(hidden.to(dtype).contiguous(),
                                           self.size, self.stride)
        return F.conv2d(hidden, weight, stride=self.stride, padding=padding)

    def forward_nchw(self, images):
        # NHWC images whose memory is NCHW: the module's permute then
        # yields contiguous NCHW
        return plain[2](self, images.permute(0, 3, 1, 2).contiguous()
                        .permute(0, 2, 3, 1))

    def norm_nhwc(self, hidden):
        x = hidden.float()
        n, c, h, w = x.shape
        grouped = x.permute(0, 2, 3, 1).reshape(n, h * w, self.groups,
                                                c // self.groups)
        var, mean = torch.var_mean(grouped, dim=(1, 3), unbiased=False,
                                   keepdim=True)
        normed = ((grouped - mean) * torch.rsqrt(var + resnet.EPSILON)
                  ).reshape(n, h, w, c)
        return (normed * self.scale + self.bias).permute(0, 3, 1, 2)

    plain = (resnet.Conv.forward, resnet.GroupNorm.forward,
             resnet.ResNet.forward)
    return {'channels_last+group_norm': plain,
            'nchw+group_norm': (conv_nchw, plain[1], forward_nchw),
            'channels_last+nhwc_norm': (plain[0], norm_nhwc, plain[2])}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('resnet_layout_ab: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from tpusystem_torch.models import resnet
    smoke = chip_smoke()
    layouts = variants(torch)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = False
    order = list(layouts) + [next(iter(layouts))]
    for name in order:
        resnet.Conv.forward, resnet.GroupNorm.forward, resnet.ResNet.forward \
            = layouts[name]
        record = smoke.train_resnet(torch, args.seed)
        profile = record.pop('profile')
        print('layout ' + json.dumps(dict(
            variant=name, **{key: record[key] for key in (
                'median_step_ms', 'min_step_ms', 'max_step_ms',
                'images_per_s', 'mfu', 'peak_memory_bytes')},
            losses=record['losses'][:2] + record['losses'][-2:],
            device_ms_per_step=profile['device_ms_per_step'],
            elementwise_ms_per_step=profile['kernel_ms_per_step'][
                'elementwise'],
            top_kernels=profile['top_kernels_us_per_step'])), flush=True)
        torch.cuda.empty_cache()
    print(smoke.card_line())


if __name__ == '__main__':
    main()
