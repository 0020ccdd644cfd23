"""Signal-analysis helpers of the IQ main path (numpy): the in-peak
multipath detector and echo-bias accounting (``multipath.py``)."""
