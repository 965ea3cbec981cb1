"""Graph containers, generators and the device-resident ``DeviceGraph``."""
