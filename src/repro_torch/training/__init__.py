"""The single-device trainer of the port: AdamW, the train step,
checkpoints and the fault-tolerance controller."""
