from .synthetic import blobs, DATASET_SPECS  # noqa: F401
