"""Host-side native code of the port: the packed tile store (``.msts``),
whose C++ reader g++ builds at first use (``native/tilestore.py``)."""

from maskedsst_tpu_torch.native.tilestore import PackedTileStore, pack_tiles  # noqa: F401
