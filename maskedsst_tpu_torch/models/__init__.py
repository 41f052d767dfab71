from maskedsst_tpu_torch.models.simmim import SimMIMSpatialSpectral
from maskedsst_tpu_torch.models.vit_spatial_spectral import ViTSpatialSpectral

__all__ = ["SimMIMSpatialSpectral", "ViTSpatialSpectral"]
