"""The yardstick of the kernels' roofline shares: the card's peaks, fixed,
and the operations and bytes each kernel's inputs need."""
