"""Sensor wavelength tables, used to place spectral blocks in the
positional embedding (``config.get_spectral_pos``).

These are physical facts about the EnMAP and Houston2018 (CASI) sensors:
the port keeps its own copy so that it imports nothing of the JAX package.
"""

# EnMAP L2 band-center wavelengths [nm] for the 224-band product
ENMAP_WAVELENGTHS = [
    418.24, 423.874, 429.294, 434.528, 439.603, 444.549,
    449.391, 454.159, 458.884, 463.584, 468.265, 472.934,
    477.599, 482.265, 486.941, 491.633, 496.349, 501.094,
    505.87, 510.678, 515.519, 520.397, 525.313, 530.268,
    535.265, 540.305, 545.391, 550.525, 555.71, 560.947,
    566.239, 571.587, 576.995, 582.464, 587.997, 593.596,
    599.267, 605.011, 610.833, 616.737, 622.732, 628.797,
    634.919, 641.1, 647.341, 653.643, 660.007, 666.435,
    672.927, 679.485, 686.11, 692.804, 699.567, 706.401,
    713.307, 720.282, 727.324, 734.431, 741.601, 748.833,
    756.124, 763.472, 770.876, 778.333, 785.843, 793.402,
    801.01, 808.665, 816.367, 824.112, 831.901, 839.731,
    847.601, 855.509, 863.455, 871.433, 879.442, 887.478,
    895.537, 902.257, 903.617, 911.715, 911.872, 919.827,
    921.624, 927.951, 931.512, 936.082, 941.53, 944.217,
    951.677, 952.355, 960.495, 961.948, 968.638, 972.341,
    976.783, 982.851, 984.932, 993.083, 993.475, 1004.21,
    1015.05, 1026.0, 1037.05, 1048.19, 1059.42, 1070.74,
    1082.14, 1093.62, 1105.17, 1116.79, 1128.47, 1140.2,
    1151.98, 1163.81, 1175.67, 1187.56, 1199.48, 1211.42,
    1223.37, 1235.34, 1247.31, 1259.3, 1271.29, 1283.29,
    1295.28, 1307.27, 1319.25, 1331.22, 1343.18, 1355.13,
    1367.06, 1378.96, 1390.84, 1461.46, 1473.1, 1484.69,
    1496.24, 1507.75, 1519.22, 1530.64, 1542.02, 1553.36,
    1564.65, 1575.9, 1587.1, 1598.26, 1609.36, 1620.43,
    1631.44, 1642.41, 1653.33, 1664.2, 1675.03, 1685.8,
    1696.53, 1707.2, 1717.83, 1728.4, 1738.93, 1749.4,
    1759.83, 1939.44, 1948.98, 1958.49, 1967.95, 1977.37,
    1986.74, 1996.07, 2005.36, 2014.61, 2023.82, 2032.99,
    2042.11, 2051.19, 2060.24, 2069.24, 2078.21, 2087.13,
    2096.01, 2104.86, 2113.67, 2122.44, 2131.17, 2139.87,
    2148.52, 2157.15, 2165.73, 2174.28, 2182.79, 2191.27,
    2199.71, 2208.12, 2216.5, 2224.84, 2233.14, 2241.42,
    2249.66, 2257.86, 2266.04, 2274.18, 2282.29, 2290.37,
    2298.42, 2306.44, 2314.42, 2322.37, 2330.29, 2338.19,
    2346.05, 2353.88, 2361.68, 2369.45, 2377.19, 2384.9,
    2392.58, 2400.23, 2407.85, 2415.45, 2423.01, 2430.55,
    2438.05, 2445.53,
]

# True where the EnMAP L2 band is empty/invalid (water-vapour windows)
ENMAP_INVALID_L2_BANDS = [
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, True, True, True, True,
    True, True, True, True, True, True, True, True, True, True,
    True, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    True, True, True, True, True, True, True, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False,
]

# Houston2018 (CASI) 48 HSI band-center wavelengths [nm]
HOUSTON2018_WAVELENGTHS = [
    374.399994, 388.700012, 403.100006, 417.399994, 431.700012, 446.100006,
    460.399994, 474.700012, 489.0, 503.399994, 517.700012, 532.0,
    546.299988, 560.599976, 574.900024, 589.200012, 603.599976, 617.900024,
    632.200012, 646.5, 660.799988, 675.099976, 689.400024, 703.700012,
    718.0, 732.299988, 746.599976, 760.900024, 775.200012, 789.5,
    803.799988, 818.099976, 832.400024, 846.700012, 861.099976, 875.400024,
    889.700012, 904.0, 918.299988, 932.599976, 946.900024, 961.200012,
    975.5, 989.799988, 1004.200012, 1018.5, 1032.800049, 1047.099976,
]
