from maskedsst_tpu_torch.models.simmim import SimMIM, SimMIMSpatialSpectral
from maskedsst_tpu_torch.models.vit_rgb import ViTOriginal, ViTRGB
from maskedsst_tpu_torch.models.vit_spatial_spectral import ViTSpatialSpectral
from maskedsst_tpu_torch.models.vit_spatial_spectral_v1 import ViTSpatialSpectralV1

__all__ = ["SimMIM", "SimMIMSpatialSpectral", "ViTOriginal", "ViTRGB", "ViTSpatialSpectral",
           "ViTSpatialSpectralV1"]
