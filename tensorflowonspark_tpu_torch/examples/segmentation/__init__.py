"""The segmentation example of the port: the U-Net trained through
TFCluster.run, then multi-worker inference through TFParallel."""
