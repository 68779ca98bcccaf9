"""DRUNet (UNetRes) denoiser, NCHW.

Counterpart of dprox_tpu/models/drunet.py::UNetRes: bias-free conv head,
3 scales of [nb ResBlocks + strided-conv down], nb-ResBlock body,
mirrored transpose-conv ups with additive skips, conv tail. The input
carries a noise-level map channel (in_nc = C + 1). Attribute names are
the reference's (KAIR network_unet.py: ``m_head``, ``m_down1..3``,
``m_body``, ``m_up3..1``, ``m_tail``), so its checkpoints load with
``load_state_dict``.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from .blocks import Conv, DownStrideConv, ResBlock, UpTransposeConv


class UNetRes(nn.Module):
    def __init__(self, in_nc: int = 2, out_nc: int = 1, nc: Sequence[int] = (64, 128, 256, 512),
                 nb: int = 4):
        super().__init__()
        self.m_head = Conv(in_nc, nc[0], bias=False)
        for s in range(3):
            self.add_module(f"m_down{s + 1}", nn.Sequential(
                *[ResBlock(nc[s]) for _ in range(nb)], DownStrideConv(nc[s], nc[s + 1])))
        self.m_body = nn.Sequential(*[ResBlock(nc[3]) for _ in range(nb)])
        for s in (3, 2, 1):
            self.add_module(f"m_up{s}", nn.Sequential(
                UpTransposeConv(nc[s], nc[s - 1]), *[ResBlock(nc[s - 1]) for _ in range(nb)]))
        self.m_tail = Conv(nc[0], out_nc, bias=False)

    def forward(self, x0):
        x1 = self.m_head(x0)
        x2 = self.m_down1(x1)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        x = self.m_body(x4)
        x = self.m_up3(x + x4)
        x = self.m_up2(x + x3)
        x = self.m_up1(x + x2)
        return self.m_tail(x + x1)
