"""Examples of the port, the counterparts of the repository's
``examples/``: ``ingest_pipeline`` (decode on the card into a toy vision
model's input) and ``serving_codec`` (routing by size over the packed and
bucketed engines).  Run each as ``python -m
qoipp_tpu_torch.examples.<name>``; both take ``--cpu``.
"""
