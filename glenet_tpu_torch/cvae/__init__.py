"""GLENet's label-uncertainty generator (torch counterpart of
glenet_tpu/cvae/): the CVAE over per-object point crops, its crop
datasets with K-fold splits, the K-fold training / prediction / variance
mapping / info injection pipeline, and the offline analysis."""
