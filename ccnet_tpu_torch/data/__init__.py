from ccnet_tpu_torch.data.cityscapes import (
    CITYSCAPES_CLASS_NAMES,
    CITYSCAPES_ID_TO_TRAINID,
    CityscapesDataset,
    trainid_lut,
    trainid_to_labelid,
)
from ccnet_tpu_torch.data.lists import generate_cityscapes_lists, generate_voc_lists
from ccnet_tpu_torch.data.loader import (
    AugmentingDataset,
    CachedDataset,
    DataLoader,
    HostToDevice,
    SyntheticDataset,
    Transfer,
    U8CropDataset,
    device_prefetch,
)
from ccnet_tpu_torch.data.palette import cityscapes_palette, save_indexed_png
from ccnet_tpu_torch.data.preprocess import (
    CITYSCAPES_MEAN_BGR,
    device_augment_batch,
    finish_u8_crops,
    host_augment,
    host_augment_u8,
)
from ccnet_tpu_torch.data.voc import VOC_CLASS_NAMES, VOC_MEAN, VOCDataset

__all__ = [
    "AugmentingDataset",
    "CITYSCAPES_CLASS_NAMES",
    "CITYSCAPES_ID_TO_TRAINID",
    "CITYSCAPES_MEAN_BGR",
    "CachedDataset",
    "CityscapesDataset",
    "DataLoader",
    "HostToDevice",
    "SyntheticDataset",
    "Transfer",
    "U8CropDataset",
    "cityscapes_palette",
    "device_augment_batch",
    "device_prefetch",
    "finish_u8_crops",
    "generate_cityscapes_lists",
    "generate_voc_lists",
    "host_augment",
    "host_augment_u8",
    "save_indexed_png",
    "trainid_lut",
    "trainid_to_labelid",
    "VOC_CLASS_NAMES",
    "VOC_MEAN",
    "VOCDataset",
]
