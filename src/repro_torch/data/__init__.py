from repro_torch.data.partition import partition_iid, partition_paper
from repro_torch.data.synthetic import (batch_iterator,
                                        make_binary_classification,
                                        make_multiclass_images,
                                        make_token_stream)

__all__ = ["batch_iterator", "make_binary_classification",
           "make_multiclass_images", "make_token_stream", "partition_iid",
           "partition_paper"]
