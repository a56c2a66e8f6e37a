"""The yardstick's arithmetic: the H100's published peaks, the model's
operations counted from the plain reference, and the operations and bytes
of the hand-written ops, from their own inputs and outputs."""
