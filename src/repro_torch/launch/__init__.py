"""Entry points of the port (the only place its library code prints):

  dlrm_serve  the distributed DLRM server and its CLI
"""
