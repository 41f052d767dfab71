from maskedsst_tpu_torch.models.vit_spatial_spectral import ViTSpatialSpectral

__all__ = ["ViTSpatialSpectral"]
