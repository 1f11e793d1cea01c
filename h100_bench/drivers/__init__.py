"""The drivers of the cells, one a traffic ``kind``: ``drivers/<kind>.py``
defines ``Driver``, which the runner finds by the kind's name."""
