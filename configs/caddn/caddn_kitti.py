"""CaDDN on KITTI at the JAX model's defaults (``detmatch_tpu/models/
pvrcnn/caddn.py``; upstream pcdet ``CaDDN.yaml``): a 280 x 376 x 25 grid
of 0.16 m voxels over (2, -30.08, -3) - (46.8, 30.08, 1) m, 80 LID depth
bins over 2 - 46.8 m, stride-4 image features, stride-2 anchors.

``model.detector_mono`` is what the monocular demo builds
(``demo/mono_demo.py``; ``python -m detmatch_tpu_torch.demo.mono_demo``).
"""

point_cloud_range = [2.0, -30.08, -3.0, 46.8, 30.08, 1.0]

model = dict(
    detector_mono=dict(
        num_classes=3, point_cloud_range=tuple(point_cloud_range),
        voxel_size=(0.16, 0.16, 0.16), grid_size=(280, 376, 25),
        depth_bins=80, depth_range=(2.0, 46.8), depth_mode="LID",
        downsample=4),
)
