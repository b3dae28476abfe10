"""PAL → equirectangular panorama remap.

Port of ``lfvio_tpu.runtime.panorama`` (the pointcloud_image_fusion node's
remap-table construction and cv::remap, pointcloud_image_fusion.cpp:83-114):
the inverse map (pano pixel → direction → camera pixel through the camera's
``space_to_plane``) is built once on the host; every frame is then one
bilinear gather on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


class PanoramaRemapper:
    def __init__(self, camera, src_shape, pano_width=1024, pano_height=256,
                 lat_min_deg=-50.0, lat_max_deg=40.0, dtype=torch.float32, device=None):
        """The latitude range covers the PAL annulus's elevation span
        (reference rig: 360° × (−50°..+40°) about the horizon). The maps
        and every remapped frame live on ``device`` (None: the CUDA card)."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self.H, self.W = src_shape
        lon = np.linspace(-np.pi, np.pi, pano_width, endpoint=False)
        lat = np.linspace(np.radians(lat_max_deg), np.radians(lat_min_deg), pano_height)
        lon_g, lat_g = np.meshgrid(lon, lat)
        # d = (cos(lat)cos(lon), cos(lat)sin(lon), -sin(lat)): lat > 0 lands
        # on the inner annulus (theta > 0 in spaceToPlane's atan2(-z, r)).
        d = np.stack([np.cos(lat_g) * np.cos(lon_g), np.cos(lat_g) * np.sin(lon_g),
                      -np.sin(lat_g)], axis=-1)
        # On the host, in float64 over the camera's own parameter values.
        cam = camera.to(device="cpu", dtype=torch.float64)
        pix = cam.space_to_plane(torch.as_tensor(d.reshape(-1, 3))).numpy()
        to_dev = lambda a: torch.as_tensor(a.reshape(pano_height, pano_width), dtype=dtype,
                                           device=self.device)
        self.map_x, self.map_y = to_dev(pix[:, 0]), to_dev(pix[:, 1])
        # The maps are fixed, so is everything but the frame's values: the
        # four source pixels of each pano pixel and their bilinear weights,
        # zero where the source falls outside the frame.
        H, W = self.H, self.W
        x = torch.clamp(self.map_x, 0.0, W - 1.001)
        y = torch.clamp(self.map_y, 0.0, H - 1.001)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx, fy = x - x0, y - y0
        i00 = y0 * W + x0
        self._index = torch.stack([i00, i00 + 1, i00 + W, i00 + W + 1])
        inside = ((self.map_x >= 0) & (self.map_x < W - 1) & (self.map_y >= 0)
                  & (self.map_y < H - 1)).to(dtype)
        self._weight = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx]) * inside

    def remap(self, img):
        """[pano_height, pano_width] panorama of an [H, W] frame (a tensor
        or an array): one gather of the four source pixels and their
        weighted sum; pano pixels whose source falls outside the frame are 0."""
        img = torch.as_tensor(img).to(device=self.device, dtype=self.dtype)
        if tuple(img.shape) != (self.H, self.W):
            raise ValueError(f"frame of shape {tuple(img.shape)}, maps built for {(self.H, self.W)}")
        return (img.reshape(-1)[self._index] * self._weight).sum(dim=0)
