"""Search core of the port: IVF-PQ, ChamVS, k-means, the kNN-LM mix."""
