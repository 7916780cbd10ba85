"""The traffic mixes' code; a traffic file names its module by the key
``mix``."""
