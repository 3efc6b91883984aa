"""FPN neck and heads, proposal generation, the detector."""
