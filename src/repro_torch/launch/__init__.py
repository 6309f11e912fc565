"""Launchers: the train and serve drivers, the dry run and its roofline."""
