"""Host-side data pipeline of the port: h5/NIfTI volume stores, slice-window
assembly, augmentation, batch loaders (the port's own copy of
``afcm_tpu/data``), and the in-memory phantom subjects of ``demo``."""

from .h5_dataset import (AbstractVolumeDataset, CmsrDataset,
                         StandardHDF5Dataset, calculate_stats)
from .loader import (TestLoader, TrainLoader, create_dataset,
                     get_test_loaders, get_train_loaders)
from .slice_builder import (FilterGraySliceBuilder, FilterSliceBuilder,
                            SliceBuilder, get_slice_builder)
from .transforms import Compose, Transformer

__all__ = [
    "AbstractVolumeDataset", "CmsrDataset", "Compose", "FilterGraySliceBuilder",
    "FilterSliceBuilder", "SliceBuilder", "StandardHDF5Dataset", "TestLoader",
    "TrainLoader", "Transformer", "calculate_stats", "create_dataset",
    "get_slice_builder", "get_test_loaders", "get_train_loaders",
]
