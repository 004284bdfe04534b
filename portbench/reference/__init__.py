"""Plain PyTorch reference of 3DFeat-Net (arXiv:1807.09413), written from
the paper and the reference's feat3dnet.py / inference.py / train.py.

It imports nothing of the program under test: weights, inputs, neighbour
sets, keypoints and descriptors are worked out here from what the
benchmark itself made or read.
"""
