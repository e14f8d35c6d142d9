"""Host-side datasets and input pipelines with device prefetch."""

from pgx_torch.data.datasets import (  # noqa: F401
    ArrayDataset,
    ImageFolderDataset,
    WikiArtDataset,
    load_cifar10,
    load_mnist,
    load_sklearn_digits,
    synthetic_dataset,
)
from pgx_torch.data.pipeline import (  # noqa: F401
    DevicePrefetcher,
    array_batches,
    folder_batches,
    normalize_to_unit,
)
