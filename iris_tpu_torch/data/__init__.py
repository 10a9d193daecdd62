from iris_tpu_torch.data.datasets import (  # noqa: F401
    RayBatcher, RealDataset, ScannetppDataset, SyntheticDataset, load_dataset,
)
