from ccnet_tpu_torch.data.cityscapes import (
    CITYSCAPES_CLASS_NAMES,
    CITYSCAPES_ID_TO_TRAINID,
    CityscapesDataset,
    trainid_lut,
    trainid_to_labelid,
)
from ccnet_tpu_torch.data.loader import DataLoader, SyntheticDataset, U8CropDataset
from ccnet_tpu_torch.data.palette import cityscapes_palette, save_indexed_png
from ccnet_tpu_torch.data.preprocess import (
    CITYSCAPES_MEAN_BGR,
    device_augment_batch,
    finish_u8_crops,
)

__all__ = [
    "CITYSCAPES_CLASS_NAMES",
    "CITYSCAPES_ID_TO_TRAINID",
    "CITYSCAPES_MEAN_BGR",
    "CityscapesDataset",
    "DataLoader",
    "SyntheticDataset",
    "U8CropDataset",
    "cityscapes_palette",
    "device_augment_batch",
    "finish_u8_crops",
    "save_indexed_png",
    "trainid_lut",
    "trainid_to_labelid",
]
