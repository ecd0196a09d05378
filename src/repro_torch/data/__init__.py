from repro_torch.data.partition import partition_iid, partition_paper
from repro_torch.data.synthetic import (make_binary_classification,
                                        make_multiclass_images)

__all__ = ["make_binary_classification", "make_multiclass_images",
           "partition_iid", "partition_paper"]
