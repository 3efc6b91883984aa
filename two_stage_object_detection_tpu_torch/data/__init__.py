"""Host data pipeline: COCO ingest, augmentation, native decode, loaders."""
