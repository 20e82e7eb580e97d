from .synthetic import blobs, dataset_standin, DATASET_SPECS  # noqa: F401
