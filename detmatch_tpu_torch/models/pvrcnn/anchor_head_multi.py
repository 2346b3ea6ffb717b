"""AnchorHeadMulti (counterpart of
``detmatch_tpu/models/pvrcnn/anchor_head_multi.py``; pcdet
``anchor_head_multi.py``): a shared 3 × 3 conv trunk, then one head of
cls / box / dir 1 × 1 convs per class group. Each group's predictions go
back into the flat (H, W, class, rotation) anchor order of
:class:`AnchorHeadSingle`, whose targets, losses and decode apply
unchanged; a group's anchors get logit -1e9 for the classes outside the
group, as JAX's."""
from __future__ import annotations

import torch
from torch import nn

from ..init import init_like_jax
from .anchor_head import AnchorHeadSingle

NEG_LOGIT = -1e9


class AnchorHeadMulti(AnchorHeadSingle):
    """``head_groups``: tuples of class names, e.g. (("Car",),
    ("Pedestrian", "Cyclist")), covering every anchor class once (one
    group a class if empty). Parameters ``shared_conv`` and
    ``rpn_heads.{i}.conv_cls / conv_box / conv_dir_cls``."""

    def __init__(self, input_channels, head_groups=(),
                 shared_conv_channels=64, **kwargs):
        super().__init__(shared_conv_channels, **kwargs)
        del self.conv_cls, self.conv_box, self.conv_dir_cls
        configs = kwargs["anchor_configs"]
        names = [cfg["class_name"] for cfg in configs]
        groups = head_groups or [(n,) for n in names]
        self.group_idx = [tuple(names.index(n) for n in grp)
                          for grp in groups]
        if sorted(i for g in self.group_idx for i in g) != list(
                range(len(names))):
            raise ValueError("head_groups must cover every anchor class "
                             "exactly once")
        self.num_rot = len(configs[0]["anchor_rotations"])
        self.shared_conv = nn.Conv2d(input_channels, shared_conv_channels,
                                     3, padding=1)
        self.rpn_heads = nn.ModuleList()
        for grp in self.group_idx:
            na = len(grp) * self.num_rot
            head = nn.ModuleDict(dict(
                conv_cls=nn.Conv2d(shared_conv_channels, na * len(grp), 1),
                conv_box=nn.Conv2d(shared_conv_channels,
                                   na * self.coder.code_size, 1),
                conv_dir_cls=nn.Conv2d(shared_conv_channels,
                                       na * self.num_dir_bins, 1)))
            self.rpn_heads.append(head)
        init_like_jax(self)  # no detector of the port holds this head

    def init_explicit(self):
        """JAX's class bias -4.595 and N(0, 0.001) box weights a group
        (``anchor_head_multi.py:45,48`` there)."""
        for head in self.rpn_heads:
            nn.init.constant_(head.conv_cls.bias, -4.595)
            nn.init.normal_(head.conv_box.weight, std=0.001)

    def forward(self, bev_features):
        """(B, C, H, W) → flat per-anchor predictions, as
        :meth:`AnchorHeadSingle.forward`."""
        x = torch.relu(self.shared_conv(bev_features))
        b, _, h, w = x.shape
        n_cls, r, code = self.num_classes, self.num_rot, self.coder.code_size
        cls_full = x.new_full((b, h, w, n_cls, r, n_cls), NEG_LOGIT)
        box_full = x.new_zeros((b, h, w, n_cls, r, code))
        dir_full = x.new_zeros((b, h, w, n_cls, r, self.num_dir_bins))
        for head, grp in zip(self.rpn_heads, self.group_idx):
            g = len(grp)

            def nhwc(conv, width):
                return conv(x).permute(0, 2, 3, 1).reshape(b, h, w, g, r,
                                                           width)

            cls = nhwc(head.conv_cls, g)
            box = nhwc(head.conv_box, code)
            dirp = nhwc(head.conv_dir_cls, self.num_dir_bins)
            for li, ci in enumerate(grp):
                # a group anchor predicts the logits of its group's classes
                for lj, cj in enumerate(grp):
                    cls_full[:, :, :, ci, :, cj] = cls[:, :, :, li, :, lj]
                box_full[:, :, :, ci] = box[:, :, :, li]
                dir_full[:, :, :, ci] = dirp[:, :, :, li]
        a = h * w * n_cls * r
        return dict(cls_preds=cls_full.reshape(b, a, n_cls),
                    box_preds=box_full.reshape(b, a, code),
                    dir_preds=dir_full.reshape(b, a, self.num_dir_bins))
