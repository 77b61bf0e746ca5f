"""Batched checking on the device: many histories decided as one search
(``check_batch``), the counterpart of the reference's
``jepsen_tpu.parallel``. The multi-device pieces (``mesh=``, the sharded
frontier) come with a later slice."""

from .batch import check_batch, check_encoded_batch, check_histories

__all__ = ["check_batch", "check_encoded_batch", "check_histories"]
