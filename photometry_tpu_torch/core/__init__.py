"""Engine, metrics, motion, time correction, dispatcher and drain of the port."""
