"""Host Bubble-tree, clustering features, Borůvka and the device
hierarchy of the PyTorch port."""
