from .pyramid import gaussian_pyramid
from .klt_cuda import pyramidal_lk  # the kernel on CUDA tensors, plain on CPU
from .detect import shi_tomasi_response, select_features, annulus_mask
from .clahe import clahe
from .ransac import spherical_ransac_e
