"""The general drivers: `drivers/<name>.py` holds the driver that traffic
files name by their `driver` key, as its class `DRIVER` (`Spec.driver`)."""
