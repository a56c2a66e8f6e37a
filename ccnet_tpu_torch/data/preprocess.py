"""Preprocessing constants. The device-side augmentation of
:mod:`ccnet_tpu.data.preprocess` comes with the training port; evaluation
needs only the mean, which the Evaluator subtracts on the device."""

# reference train.py:30 (BGR order, matches cv2 imread)
CITYSCAPES_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)
