"""Input-side helpers of the port (the real-data input plane comes in a later
slice)."""
