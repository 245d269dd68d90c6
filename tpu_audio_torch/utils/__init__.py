"""Pure-Python helpers of the port."""
